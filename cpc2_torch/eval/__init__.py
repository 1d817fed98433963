"""Evaluations of a trained model: ABX."""

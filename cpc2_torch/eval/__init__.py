"""Evaluations of a trained model: ABX and linear separability."""

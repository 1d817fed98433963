"""Host-side data-preparation and run-inspection CLIs (counterpart of
`cpc2_tpu/tools/`): resampling, best-epoch selection, power-of-two
curricula, RTTM segment extraction and SNR/C50 filtering."""

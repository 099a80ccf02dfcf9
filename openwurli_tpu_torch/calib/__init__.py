"""The calibration pipeline on torch: single-bin spectra, harmonic
features, note and onset extraction, residuals, MLP training, the alias
audit, the gain-chain sweep (`calibrate.run_calibrate`) and the 7-stage
`pipeline`. Port of `openwurli_tpu/calib/`."""

"""Host utilities (counterpart of `supereight_tpu/utils`): performance
samples."""

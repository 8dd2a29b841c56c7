"""Dataset converters to the SLAMBench ``.raw`` stream (counterpart of
`supereight_tpu/tools`)."""

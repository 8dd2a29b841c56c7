"""Command-line frontends (counterpart of `supereight_tpu/apps`): the
benchmark loop with its per-frame TSV log, the trajectory evaluation and the
dataset runner."""

"""Command-line frontends (counterpart of `supereight_tpu/apps`): the
benchmark loop with its per-frame TSV log, the trajectory evaluation, the
dataset runner and the headless viewer."""

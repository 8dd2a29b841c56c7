"""Tests of the benchmark (``python -m pytest slambench/tests``)."""

"""CPU tests of the benchmark (`python -m pytest gsbench/tests`), and the
card's (`python -m pytest gsbench/tests -m cuda`, on the chip)."""

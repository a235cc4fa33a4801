"""CPU tests of the benchmark (and one file for the card): ``python -m pytest portbench/tests -q``."""

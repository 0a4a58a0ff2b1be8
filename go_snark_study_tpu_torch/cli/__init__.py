"""go-snark-cli-torch (reference: cli/main.go; port of
``go_snark_study_tpu/cli/``)."""

from .main import build_parser, main

__all__ = ["build_parser", "main"]

"""`python -m ntt_cuda_tpu_torch <command>`: the CLI (cli.py)."""

import sys

from .cli import main

sys.exit(main())

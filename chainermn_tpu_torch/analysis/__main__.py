"""``python -m chainermn_tpu_torch.analysis`` — see cli.py for the contract."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())

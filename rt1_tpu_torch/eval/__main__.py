"""`python -m rt1_tpu_torch.eval`: the closed-loop eval CLI (`main.py`)."""

import sys

from rt1_tpu_torch.eval.main import main

if __name__ == "__main__":
    sys.exit(main())

"""Entry point: ``python -m torchrec_tpu_torch.obs report ...``."""

import sys

from torchrec_tpu_torch.obs.report import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

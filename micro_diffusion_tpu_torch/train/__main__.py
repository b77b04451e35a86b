"""``python -m micro_diffusion_tpu_torch.train --config-path ... --config-name ...``
(train/cli.py)."""

import sys

from .cli import main

if __name__ == "__main__":
    main(sys.argv[1:])

"""python -m dynseg_torch: the port's command line (dynseg_torch.cli)."""

import sys

from dynseg_torch.cli import main

sys.exit(main())

"""``python -m sctools_tpu_torch.analysis`` entry point."""

import sys

from .cli import main

sys.exit(main())

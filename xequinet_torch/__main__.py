"""``python -m xequinet_torch ...``: the port's command line (``cli.main``)."""

import sys

from .cli import main

sys.exit(main())

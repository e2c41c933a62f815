"""``python -m pixo_tpu_torch``: the CLI entry point (analog of the
reference's ``pixo`` binary, src/bin/pixo.rs:515)."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())

"""`python -m fea_tpu_torch [--device D] <command>`: the port's CLI
(fea_tpu_torch/cli.py). The device is an option of the CLI, not an
environment variable."""

from .cli import main

if __name__ == "__main__":
    main()

"""``python -m elasticdl_tpu_torch.cli {train|evaluate|predict} ...``: the
port's command line (``elasticdl_tpu/cli.py``'s counterpart); see
``api.py``."""

import sys


def main(argv=None, jobs=None):
    from elasticdl_tpu_torch import api

    argv = sys.argv[1:] if argv is None else argv
    return api.cli_main(argv, jobs=jobs)


if __name__ == "__main__":
    sys.exit(main())

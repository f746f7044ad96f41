"""The parameter-server process entry, the counterpart of
``elasticdl_tpu/ps/main.py``::

    python -m elasticdl_tpu_torch.ps.main --ps_id I --port P \\
        --model_zoo Z --model_def M [--device cuda|cpu] \\
        [--ps_snapshot_versions N --ps_snapshot_dir D]

See ``ps/parameter_server.py``.
"""

import sys

from elasticdl_tpu_torch.ps.parameter_server import main

if __name__ == "__main__":
    sys.exit(main())

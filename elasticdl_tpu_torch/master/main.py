"""The master process entry, the counterpart of
``elasticdl_tpu/master/main.py``::

    python -m elasticdl_tpu_torch.master.main --job_name J \\
        --model_zoo Z --model_def M --training_data D --port P \\
        [--num_ps_pods 2] [--device cuda|cpu] ...

See ``master/master.py`` (``main``).
"""

import sys

from elasticdl_tpu_torch.master.master import main

if __name__ == "__main__":
    sys.exit(main())

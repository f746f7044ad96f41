"""The parameter-server process entry, the counterpart of
``elasticdl_tpu/ps/main.py``: not ported. The PS fleet (its servicer,
the workers' ``--ps_addrs`` client, snapshots, ``--ps_device``) is the
next slice; until then ``python -m elasticdl_tpu_torch.ps.main`` raises
``NotImplementedError`` by name. The master-held model
(ParameterServerStrategy with ``--num_ps_pods 0``) needs no PS process.
"""

import sys


def main(argv=None):
    del argv
    raise NotImplementedError(
        "the parameter-server fleet (python -m elasticdl_tpu_torch.ps.main, "
        "--ps_addrs) is not ported yet (ROADMAP A5); the master-held model "
        "(--num_ps_pods 0) runs without it"
    )


if __name__ == "__main__":
    sys.exit(main())

"""``python -m ray_lightning_tpu_torch``: the port's command line. So far
one subcommand, ``supervise`` (resilience/cli.py): a distributed fit
under the resilience supervisor, or ``--smoke``, its fault-injection
gate::

    python -m ray_lightning_tpu_torch supervise --smoke --device cpu
    python -m ray_lightning_tpu_torch supervise my_project.jobs:make_job \\
        --processes 1 --max-restarts 3
"""
import sys

from ray_lightning_tpu_torch.resilience.cli import main

if __name__ == "__main__":
    sys.exit(main())

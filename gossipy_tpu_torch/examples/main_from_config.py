"""Run any experiment from a JSON config file.

Twin of the JAX package's ``examples/main_from_config.py``: one
declarative file (:class:`gossipy_tpu_torch.config.ExperimentConfig`, the
JAX package's schema) reproduces a run end to end, on the card unless
``--device cpu`` is given:

    python3 -m gossipy_tpu_torch.examples.main_from_config \\
        examples/configs/spambase_100.json
    python3 -m gossipy_tpu_torch.examples.main_from_config --dump-default \\
        > my_exp.json

Prints the same one-line JSON summary as the other examples (repetitions
are aggregated as mean finals; ``--plot`` saves the mean±std curves).
"""

from __future__ import annotations

import argparse

from gossipy_tpu_torch.config import ExperimentConfig, run_experiment
from gossipy_tpu_torch.examples._common import finish


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("config", nargs="?",
                        help="path to an experiment JSON file")
    parser.add_argument("--dump-default", action="store_true",
                        help="print the default config as JSON and exit")
    parser.add_argument("--plot", default=None, metavar="PATH",
                        help="save mean±std evaluation curves")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.dump_default:
        print(ExperimentConfig().to_json())
        return None
    if not args.config:
        parser.error("a config file is required (or --dump-default)")
    cfg = ExperimentConfig.from_json(args.config)
    state, report = run_experiment(cfg, device=args.device)
    # Recsys experiments evaluate user-wise only (local RMSE): the local
    # curves when no global evaluation exists.
    rep0 = report[0] if isinstance(report, (list, tuple)) else report
    use_local = (not rep0.get_evaluation(False)
                 and bool(rep0.get_evaluation(True)))
    return finish(report, args, local=use_local)


if __name__ == "__main__":
    main()

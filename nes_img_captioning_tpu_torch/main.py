"""Command-line entry point of the port (port of ``nes_img_captioning_tpu/main.py``).

The reference splits a run into ``master`` and ``workers`` subcommands wired
through Redis (reference: src/main.py:24-50); here the whole population loop
is one process on one card, so ``master`` runs the experiment outright and
``workers`` only explains that.

Usage:
    python -m nes_img_captioning_tpu_torch.main master \\
        --exp_file experiments/mscoco_nes.json   # or mscoco_es.json,
                                                 # mnist_nes.json, mnist_es.json
    python -m nes_img_captioning_tpu_torch.main master --device cpu \\
        --exp_file <experiment.json> --max_iterations 3
"""

from __future__ import annotations

import argparse
import logging

from .utils.config import load_experiment
from .utils.logger import setup_logging


def run(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("who", type=str, choices=["master", "workers"])
    parser.add_argument("--algo", type=str, default=None,
                        help="nic_nes or nic_es (default: from the "
                        "experiment json)")
    parser.add_argument("--exp_file", type=str,
                        default="experiments/mscoco_nes.json")
    parser.add_argument("--plot", action="store_true", default=False)
    parser.add_argument("--max_iterations", type=int, default=None,
                        help="override config.max_nb_iterations")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (default: the card; "
                        "'cpu' runs the kernels' plain versions)")
    parser.add_argument("--num_processes", type=int, default=None)
    # accepted for reference-script compatibility; unused here
    parser.add_argument("--master_socket_path", type=str, default=None)
    parser.add_argument("--master_host", type=str, default=None)
    parser.add_argument("--master_port", type=int, default=None)
    parser.add_argument("--relay_socket_path", type=str, default=None)
    parser.add_argument("--num_workers", type=int, default=None)
    args = parser.parse_args(argv)

    setup_logging()
    if args.num_processes and args.num_processes > 1:
        raise NotImplementedError(
            "--num_processes > 1 (multi-card runs) is not ported yet")
    if args.who == "workers":
        logging.info(
            "This framework runs the population loop in one process; there "
            "is no separate worker fleet to start. Run `master`.")
        return None

    exp = load_experiment(args.exp_file)
    algo = args.algo or exp["algorithm"]
    exp["algorithm"] = algo
    if algo == "nic_es":
        from .algorithms.es import ESMaster

        logging.info("RUNNING NIC-ES")
        master = ESMaster(exp, device=args.device)
    elif algo == "nic_nes":
        from .algorithms.nes import NESMaster

        logging.info("RUNNING NIC-NES")
        master = NESMaster(exp, device=args.device)
    else:
        raise ValueError(f"unknown algorithm {algo!r}")

    from .algorithms.snapshot import save_snapshot

    try:
        master.run_master(plot=args.plot, max_iterations=args.max_iterations)
    except KeyboardInterrupt:
        save_snapshot(master.stats, master.it, master.experiment,
                      loader_state=master.loader_state())
        if args.plot:
            master.stats.plot_stats(master.experiment.snapshot_dir())
    return master


if __name__ == "__main__":
    run()

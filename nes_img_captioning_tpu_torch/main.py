"""Command-line entry point of the port (port of ``nes_img_captioning_tpu/main.py``).

The reference splits a run into ``master`` and ``workers`` subcommands wired
through Redis (reference: src/main.py:24-50); here the whole population loop
is one program, so ``master`` runs the experiment outright and ``workers``
only explains that.

A run on n ranks (``parallel/``): every process runs this same command
with its own ``--process_id``, ``--num_processes n`` and rank 0's
``--coordinator host:port``; the experiment must set ``tpu.seed``. An
experiment whose ``tpu.mesh_shape`` holds n > 1 ranks, run without
``--num_processes``, starts its n ranks on this host itself (a local
rendezvous held by this process, ``multihost.hold_rendezvous``), so one
command runs on n cards; each of those ranks runs on its share of the
host's CPU cores (``os.cpu_count() // n`` intra-op threads). A rank takes
the card ``rank % device_count`` unless ``--device`` names one.

Usage:
    python -m nes_img_captioning_tpu_torch.main master \\
        --exp_file experiments/mscoco_nes.json   # or mscoco_es.json,
                                                 # mnist_nes.json, mnist_es.json
    python -m nes_img_captioning_tpu_torch.main master --device cpu \\
        --exp_file <experiment.json> --max_iterations 3
    python -m nes_img_captioning_tpu_torch.main master --exp_file <exp.json> \\
        --coordinator 10.0.0.1:29500 --num_processes 2 --process_id 0
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from .utils.config import load_experiment, parse_tpu_config
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
    parser.add_argument("--device", type=str, default=None,
                        help="torch device to run on (default: the card, a "
                        "rank's card rank %% device_count; 'cpu' runs the "
                        "kernels' plain versions)")
    # a multi-process run (replaces the reference's Redis TCP + shared-FS
    # transport, src/dist.py:33-65): every process runs this command with
    # its own --process_id; the experiment must set tpu.seed
    parser.add_argument("--coordinator", type=str, default=None,
                        help="host:port of process 0 (the tcp rendezvous)")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    # accepted for reference-script compatibility; unused here
    parser.add_argument("--master_socket_path", type=str, default=None)
    parser.add_argument("--master_host", type=str, default=None)
    parser.add_argument("--master_port", type=int, default=None)
    parser.add_argument("--relay_socket_path", type=str, default=None)
    parser.add_argument("--num_workers", type=int, default=None)
    args = parser.parse_args(argv)

    setup_logging()
    if args.who == "workers":
        logging.info(
            "This framework runs the population loop as one program on "
            "every rank; there is no separate worker fleet to start. Run "
            "`master` (scaling comes from tpu.mesh_shape or "
            "--num_processes).")
        return None

    exp = load_experiment(args.exp_file)
    shape = parse_tpu_config(exp).mesh_shape
    n_ranks = int(np.prod(shape)) if shape else 1
    if args.num_processes is None and n_ranks > 1:
        return _start_local_ranks(args, exp, n_ranks)
    return _run_rank(args, exp)


def _run_rank(args, exp: dict, launcher_store: bool = False):
    """This process's part of the run: join the group that the arguments
    name (none without ``--num_processes``), run the master, leave."""
    from .parallel import make_mesh
    from .parallel.multihost import init_multihost, shutdown_multihost

    init_multihost(args.coordinator, args.num_processes, args.process_id,
                   device=args.device, launcher_store=launcher_store)
    try:
        return _run_master(args, exp,
                           make_mesh(parse_tpu_config(exp).mesh_shape))
    finally:
        shutdown_multihost()


def _run_master(args, exp: dict, mesh):
    algo = args.algo or exp["algorithm"]
    exp["algorithm"] = algo
    if algo == "nic_es":
        from .algorithms.es import ESMaster

        logging.info("RUNNING NIC-ES")
        master = ESMaster(exp, device=args.device, mesh=mesh)
    elif algo == "nic_nes":
        from .algorithms.nes import NESMaster

        logging.info("RUNNING NIC-NES")
        master = NESMaster(exp, device=args.device, mesh=mesh)
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


def _rank_main(rank: int, args, exp: dict, n: int, port: int,
               threads: int):
    """A local rank (a spawned process): joins the store its starter holds
    at ``port`` and runs on ``threads`` intra-op threads."""
    import torch

    setup_logging()
    torch.set_num_threads(threads)
    logging.info("local rank %d of %d: %d intra-op threads", rank, n,
                 threads)
    args = argparse.Namespace(**vars(args))
    args.coordinator = f"127.0.0.1:{port}"
    args.num_processes, args.process_id = n, rank
    _run_rank(args, exp, launcher_store=True)


def _start_local_ranks(args, exp: dict, n: int):
    """Run this command as ``n`` ranks on this host, each in a spawned
    process that joins the rendezvous this process holds and runs on its
    share of the host's cores (``n`` ranks each running as many threads
    as there are cores would contend for every core); returns when all
    have ended (a rank that fails ends the run with its error)."""
    import torch.multiprocessing as mp

    from .parallel.multihost import hold_rendezvous

    threads = max(1, (os.cpu_count() or 1) // n)
    logging.info("tpu.mesh_shape holds %d ranks: starting them on this host",
                 n)
    store = hold_rendezvous(n)
    mp.start_processes(_rank_main,
                       args=(args, exp, n, store.port, threads), nprocs=n,
                       join=True, start_method="spawn")
    return None


if __name__ == "__main__":
    run()

"""The CIDEr-parity runbook on the PyTorch port: one command, four steps.

The port's counterpart of ``scripts/parity_run.py``, with the same flags
(``--device`` in place of ``--platform``) and the same summary keys. Given
a data dir laid out the reference's way (cocotalk.json, cocotalk_label.h5,
a feature dir) and optionally the reference's pretrained .pth and its
frozen coco-train-idxs DF pickle, it runs

    1. the bit-exact .pth warm-start check (load -> save -> reload ->
       compare; reference weight layout: src/algorithm/nets.py:153-168);
    2. N generations of the mscoco_nes.json regime (NESMaster reading the
       files through CocoData);
    3. the per-generation validation CIDEr series;
    4. evaluate_checkpoints on the podium-best and current checkpoints
       (reference: src/eval_on_test.py),

prints one summary JSON as the last line of stdout and writes it to
``<out>/parity_summary.json`` (the test evaluation to
``<out>/test_output.json``). Compare ``val_cider_series`` / ``test_stats``
with a reference run at the same generation count.

Usage:
    python3 scripts/torch_parity_run.py --data /path/to/coco_data \\
        [--pth pretrained/bu_xent_09.pth] [--cider-df data/coco-train-idxs.p] \\
        [--generations 50] [--device cuda] [--out logs/parity_run] \\
        [--exp experiments/mscoco_nes.json] [--nb-offspring N] [--test-num N]

``--device cpu`` runs the kernels' plain versions (toy experiment files
only); the default is the card. tests/test_torch_parity_runbook.py drives
this main() end to end on a fixture.
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

FEATURE_DIRS = ("cocobu_fc", "fc", "cocotalk_fc")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def resolve_data(data_dir: str, args) -> dict:
    """caption_options paths from a data dir laid out the reference way
    (README.md:98-106): cocotalk.json + cocotalk_label.h5 + a feature dir
    (cocobu_fc/, fc/ or cocotalk_fc/); explicit --input_* flags win."""
    copts = {
        "input_json": args.input_json
        or os.path.join(data_dir, "cocotalk.json"),
        "input_label_h5": args.input_label_h5
        or os.path.join(data_dir, "cocotalk_label.h5"),
    }
    fc = args.input_fc_dir
    if not fc:
        for cand in FEATURE_DIRS:
            if os.path.isdir(os.path.join(data_dir, cand)):
                fc = os.path.join(data_dir, cand)
                break
    if not fc:
        raise SystemExit(
            f"--data {data_dir}: no feature dir found (looked for "
            f"{', '.join(d + '/' for d in FEATURE_DIRS)}); pass "
            "--input_fc_dir")
    copts["input_fc_dir"] = fc
    for k in ("input_json", "input_label_h5"):
        if not os.path.isfile(copts[k]):
            raise SystemExit(f"missing {copts[k]} (see docs/PARITY.md)")
    if args.cider_df:
        copts["cider_df"] = args.cider_df
    return copts


def check_pth_roundtrip(pth: str, copts: dict, mopts: dict,
                        out_dir: str) -> dict:
    """The warm start must be bit-exact: load the reference state_dict into
    the flat theta, write it back out, reload, and compare both the vectors
    and the re-serialized tensors. Raises SystemExit otherwise."""
    import torch

    from nes_img_captioning_tpu_torch.data.mscoco import CocoData
    from nes_img_captioning_tpu_torch.models.fc_caption import (
        FCCaptionModel,
        FCModelOptions,
    )

    data = CocoData(copts)
    spec = FCCaptionModel(FCModelOptions(
        vocab_size=data.vocab_size, seq_length=data.seq_length,
        input_encoding_size=mopts.get("input_encoding_size") or 128,
        rnn_size=mopts.get("rnn_size") or 128,
        fc_feat_size=mopts.get("fc_feat_size") or 2048,
    ), device="meta").spec
    theta = spec.load_pth(pth)
    back = os.path.join(out_dir, "roundtrip.pth")
    spec.save_pth(theta, back)
    theta2 = spec.load_pth(back)
    exact_vec = bool(torch.equal(theta, theta2))

    sd_in = torch.load(pth, map_location="cpu", weights_only=False)
    if hasattr(sd_in, "state_dict"):
        sd_in = sd_in.state_dict()
    sd_in = sd_in.get("state_dict", sd_in)
    sd_out = torch.load(back, map_location="cpu", weights_only=True)
    tensor_exact = all(
        k in sd_out and bool(torch.equal(v, sd_out[k]))
        for k, v in sd_in.items()
        if hasattr(v, "dtype") and v.dtype.is_floating_point)
    report = {
        "pth": pth,
        "num_params": int(spec.num_params),
        "vector_roundtrip_exact": exact_vec,
        "tensor_roundtrip_exact": bool(tensor_exact),
    }
    if not (exact_vec and tensor_exact):
        raise SystemExit(f"warm-start .pth round trip NOT bit-exact: {report}")
    log(f"warm start OK: {pth} ({report['num_params']} params, bit-exact)")
    return report


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data", required=True,
                   help="dir with cocotalk.json / cocotalk_label.h5 / "
                        "feature dir (reference layout)")
    p.add_argument("--input_json", default=None)
    p.add_argument("--input_label_h5", default=None)
    p.add_argument("--input_fc_dir", default=None)
    p.add_argument("--pth", default=None,
                   help="pretrained reference .pth to warm-start from "
                        "(from_single); checked bit-exact first")
    p.add_argument("--cider-df", default=None,
                   help="the reference's pickled coco-train-idxs DF table; "
                        "makes training-fitness values absolutely "
                        "comparable, not only rank-equivalent")
    p.add_argument("--generations", type=int, default=50,
                   help="N in 'CIDEr within 1 point at equal generations'")
    p.add_argument("--exp", default=None,
                   help="experiment JSON (default: the repo's "
                        "experiments/mscoco_nes.json)")
    p.add_argument("--nb-offspring", type=int, default=None,
                   help="override the config's population (pairs)")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--val-items", type=int, default=None,
                   help="override config.num_val_items")
    p.add_argument("--test-num", type=int, default=5000,
                   help="images scored by the eval_on_test leg")
    p.add_argument("--out", default=os.path.join("logs", "parity_run"))
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card; 'cpu' runs the "
                        "kernels' plain versions)")
    p.add_argument("--skip-test-eval", action="store_true")
    args = p.parse_args(argv)

    from nes_img_captioning_tpu_torch.algorithms.nes import NESMaster
    from nes_img_captioning_tpu_torch.utils.config import load_experiment
    from nes_img_captioning_tpu_torch.utils.logger import setup_logging

    setup_logging()
    os.makedirs(args.out, exist_ok=True)

    exp = load_experiment(
        args.exp or os.path.join(REPO, "experiments", "mscoco_nes.json"))
    copts = resolve_data(args.data, args)
    exp["caption_options"] = {**exp.get("caption_options", {}), **copts}
    exp["log_dir"] = os.path.join(args.out, "run")
    exp.pop("from_infos", None)
    if args.nb_offspring:
        exp["nb_offspring"] = args.nb_offspring
    if args.batch_size:
        exp["config"]["batch_size"] = args.batch_size
    if args.val_items:
        exp["config"]["num_val_items"] = args.val_items

    mopts = exp.get("policy_options", {}).get("model_options", {})
    summary: dict = {
        "generations": args.generations,
        "exp": {k: exp[k] for k in ("nb_offspring",) if k in exp},
        "config": {k: exp["config"].get(k)
                   for k in ("batch_size", "noise_stdev", "num_val_items")},
        "cider_df": args.cider_df,
    }

    # ---- 1. bit-exact warm start ------------------------------------------
    if args.pth:
        summary["warm_start"] = check_pth_roundtrip(args.pth, copts, mopts,
                                                    args.out)
        exp["from_single"] = args.pth
    else:
        exp.pop("from_single", None)
        log("no --pth: training from a fresh init (from-zero parity run)")

    # ---- 2+3. N generations + validation CIDEr series ---------------------
    master = NESMaster(exp, device=args.device)
    master.run_master(max_iterations=args.generations)
    val_series = [float(v) for v in master.stats.acc_stats()]
    score_mean = master.stats.score_stats()[1]
    summary["val_cider_series"] = val_series
    summary["final_val_cider"] = val_series[-1] if val_series else None
    summary["best_val_cider"] = max(val_series) if val_series else None
    summary["train_fitness_mean_series"] = [float(v) for v in score_mean]
    log(f"trained {args.generations} generations; val CIDEr series: "
        f"{val_series[:3]}...{val_series[-3:]}")
    del master  # its card memory, before the evaluation's decode

    # ---- 4. offline test-split eval ---------------------------------------
    if not args.skip_test_eval:
        from nes_img_captioning_tpu_torch.eval_on_test import (
            evaluate_checkpoints,
        )

        models = {}
        best = glob.glob(os.path.join(exp["log_dir"], "models", "best",
                                      "best_elite", "0_0_elite.pth"))
        if best:
            models["nicnes_best"] = best[0]
        cur = os.path.join(exp["log_dir"], "models", "current",
                           "0_current_params.pth")
        if os.path.isfile(cur):
            models["nicnes_current"] = cur
        if models:
            out = evaluate_checkpoints(
                models, copts, num=args.test_num, split="test",
                batch_size=exp["config"].get("val_batch_size") or 64,
                input_encoding_size=mopts.get("input_encoding_size") or 128,
                rnn_size=mopts.get("rnn_size") or 128,
                fc_feat_size=mopts.get("fc_feat_size") or 2048,
                device=args.device)
            summary["test_stats"] = out["stats"]
            with open(os.path.join(args.out, "test_output.json"), "w") as f:
                json.dump(out, f)
        else:
            summary["test_stats"] = None
            log("no checkpoint files found for the test-eval leg")

    with open(os.path.join(args.out, "parity_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    logging.getLogger(__name__).info("wrote %s",
                                     os.path.join(args.out,
                                                  "parity_summary.json"))
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()

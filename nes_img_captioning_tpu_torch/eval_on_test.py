"""Offline evaluation of saved .pth checkpoints on the Karpathy test split
(port of ``nes_img_captioning_tpu/eval_on_test.py``).

Reference: src/eval_on_test.py — loads up to four model-family checkpoints
(nicnes / nices / xent / sc), greedy-decodes the test split, scores them with
the COCO language metrics, and writes a JSON with per-model stats plus
per-image caption comparisons.

Each checkpoint is decoded greedily at f32, as the JAX package's
``model.sample`` does: on the card one row-block launch of K1 over the
split (``tasks/captioning.greedy_rows``, the decode of ``CocoTask``'s
validation). The kernels take any E, R <= 512 and any feature width,
zero-padded to the next built width (128, 256, 512) and to a multiple of
128; a wider model is refused on the card unless ``--eager_decode``
(``eager=True``) asks for the eager decoder, which then decodes in chunks
of ``batch_size``.

Usage:
    python -m nes_img_captioning_tpu_torch.eval_on_test \\
        --model nicnes=path/to/0_0_elite.pth --model nices=... \\
        --input_json data/cocotalk.json --input_fc_dir data/cocobu_fc \\
        --input_label_h5 data/cocotalk_label.h5 --num 5000 --out output/
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import torch

from .data.mscoco import METEOR_OPTIONS, CocoData
from .fitness.lang_metrics import language_eval
from .models.fc_caption import FCCaptionModel, FCModelOptions
from .tasks.captioning import greedy_rows, resolve_fused
from .utils.device import resolve_device
from .utils.logger import setup_logging

logger = logging.getLogger(__name__)


def evaluate_checkpoints(models: dict[str, str], caption_options: dict,
                         num: int = 5000, split: str = "test",
                         batch_size: int = 32,
                         input_encoding_size: int = 128, rnn_size: int = 128,
                         fc_feat_size: int = 2048, data: CocoData | None =
                         None, device=None, eager: bool = False) -> dict:
    """Per-model language metrics, per-image and per-model captions of the
    first ``num`` images of ``split`` (all for None, -1 or 0). ``data``: an
    in-memory CocoData used instead of reading ``caption_options``' files
    (build it with ``CocoData.from_arrays(arrays, opts=caption_options)``
    so its METEOR tables apply). ``device``: the card unless ``"cpu"``.
    ``eager``: the eager decoder instead of the kernels (``batch_size``
    sets its chunks; the kernels' launch has none)."""
    device = resolve_device(device)
    if data is None:
        data = CocoData(caption_options)
    elif any(data.opts.get(k) != caption_options.get(k)
             for k in METEOR_OPTIONS):
        raise ValueError(
            f"caption_options' METEOR keys {METEOR_OPTIONS} differ from the "
            "in-memory data's opts; build it with CocoData.from_arrays("
            "arrays, opts=caption_options)")
    options = FCModelOptions(
        vocab_size=data.vocab_size, seq_length=data.seq_length,
        input_encoding_size=input_encoding_size, rnn_size=rnn_size,
        fc_feat_size=fc_feat_size)
    model = FCCaptionModel(options, device="meta")
    fused = resolve_fused(options, False if eager else "auto", device)
    feats = data.split_feats(split)
    gts = data.split_gts(split)
    image_ids = data.split_image_ids(split)
    n = feats.shape[0] if num in (None, -1, 0) else min(num, feats.shape[0])
    feats = torch.as_tensor(feats[:n], device=device)

    all_stats: dict = {}
    preds_per_model: dict = {}
    spice_cmd = caption_options.get("spice_cmd")
    # reference captions are model-independent: decode once, reuse across
    # every checkpoint (and across the spice_items / preds entries below)
    ref_sents = [data.decode_sequence(gts[i]) for i in range(n)]
    ref_wids = [data.word_id_rows(g) for g in gts[:n]]
    for name, path in models.items():
        theta = model.spec.load_pth(path).to(device)
        seqs = greedy_rows(model, theta, feats, fused, torch.float32,
                           batch_size).cpu().numpy()
        sents = data.decode_sequence(seqs)
        spice_items = None
        if spice_cmd:
            # the external SPICE tool consumes string captions (the jar's
            # own input schema; see fitness/lang_metrics.spice_external)
            spice_items = [
                {"image_id": image_ids[i], "test": sents[i],
                 "refs": ref_sents[i]}
                for i in range(n)
            ]
        # word-level scoring: duplicate word strings collapse, matching
        # pycocoevalcap's string convention (data.word_id_rows docstring)
        stats = language_eval(
            data.word_id_rows(seqs),
            ref_wids,
            stem_of=data.word_stem_of,
            syn_of=data.word_syn_of if data.has_synonym_table() else None,
            para=data.paraphrase_table(),
            spice_cmd=spice_cmd, spice_items=spice_items,
            params15=data.meteor_params(),
        )
        logger.info("%s: %s", name, stats)
        preds_per_model[name] = [
            {"image_id": image_ids[i], "caption": sents[i],
             "gts": ref_sents[i]}
            for i in range(n)
        ]
        all_stats[name] = stats

    preds_per_img: dict = {}
    for name, preds in preds_per_model.items():
        for entry in preds:
            tmp = preds_per_img.setdefault(
                entry["image_id"], {"gts": entry["gts"]}
            )
            tmp[name] = entry["caption"]

    return {
        "stats": all_stats,
        "preds_per_img": preds_per_img,
        "preds_per_model": preds_per_model,
    }


def run(argv=None, data: CocoData | None = None):
    """The CLI. ``data``: an in-memory CocoData instead of the files the
    ``--input_*`` flags name."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", action="append", default=[],
                        help="name=path/to/checkpoint.pth (repeatable)")
    parser.add_argument("--input_json", type=str, default="data/cocotalk.json")
    parser.add_argument("--input_fc_dir", type=str, default="data/cocobu_fc")
    parser.add_argument("--input_label_h5", type=str,
                        default="data/cocotalk_label.h5")
    parser.add_argument("--split", type=str, default="test",
                        choices=["val", "test"])
    parser.add_argument("--num", type=int, default=5000)
    parser.add_argument("--batch_size", type=int, default=32,
                        help="rows per chunk of the eager decoder")
    parser.add_argument("--out", type=str, default="output")
    parser.add_argument("--meteor_synonyms", type=str, default=None,
                        help="JSON synonym table (word groups or word->class "
                        "map) enabling METEOR's synonym matcher — restores "
                        "the reference Java METEOR-1.5 WordNet stage given "
                        "equivalent data")
    parser.add_argument("--meteor_paraphrases", type=str, default=None,
                        help="JSON paraphrase table (phrase groups or "
                        "phrase->class map) enabling METEOR's phrase "
                        "matcher — restores the reference Java METEOR-1.5 "
                        "paraphrase stage given equivalent data")
    parser.add_argument("--meteor_15", action="store_true",
                        help="score METEOR with the 1.5 formulation "
                        "(parameterized Fmean/penalty, matcher weights, "
                        "tuned English defaults) instead of the 2005 one")
    parser.add_argument("--meteor_function_words", type=str, default=None,
                        help="function-word list (JSON list or one word per "
                        "line) enabling METEOR-1.5's δ weighting; implies "
                        "--meteor_15")
    parser.add_argument("--spice_cmd", type=str, default=None,
                        help="external SPICE command template ({input}/"
                        "{output} placeholders, or both paths appended); "
                        "e.g. 'java -jar spice.jar {input} -out {output} "
                        "-subset'. SPICE is reported as null when unset")
    # model dims (the reference hard-codes 128/2048, eval_on_test.py:44-49)
    parser.add_argument("--input_encoding_size", type=int, default=128)
    parser.add_argument("--rnn_size", type=int, default=128)
    parser.add_argument("--fc_feat_size", type=int, default=2048)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (default: the card; "
                        "'cpu' runs the kernels' plain versions)")
    parser.add_argument("--eager_decode", action="store_true",
                        help="decode with the eager decoder instead of the "
                        "kernels (tpu.fused_decode: false); needed on the "
                        "card for input_encoding_size or rnn_size above "
                        "512")
    args = parser.parse_args(argv)

    setup_logging()
    models = dict(m.split("=", 1) for m in args.model)
    if not models:
        parser.error("at least one --model name=path required")

    copts = {
        "input_json": args.input_json,
        "input_fc_dir": args.input_fc_dir,
        "input_label_h5": args.input_label_h5,
    }
    if args.meteor_synonyms:
        copts["meteor_synonyms"] = args.meteor_synonyms
    if args.meteor_paraphrases:
        copts["meteor_paraphrases"] = args.meteor_paraphrases
    if args.meteor_15 or args.meteor_function_words:
        copts["meteor_params"] = True
    if args.meteor_function_words:
        copts["meteor_function_words"] = args.meteor_function_words
    if args.spice_cmd:
        copts["spice_cmd"] = args.spice_cmd
    out = evaluate_checkpoints(models, copts, num=args.num, split=args.split,
                               batch_size=args.batch_size,
                               input_encoding_size=args.input_encoding_size,
                               rnn_size=args.rnn_size,
                               fc_feat_size=args.fc_feat_size, data=data,
                               device=args.device, eager=args.eager_decode)
    os.makedirs(args.out, exist_ok=True)
    out_path = os.path.join(args.out, f"test_output_{os.getpid()}.json")
    with open(out_path, "w") as f:
        json.dump(out, f)
    logger.info("wrote %s", out_path)
    return out


if __name__ == "__main__":
    run()

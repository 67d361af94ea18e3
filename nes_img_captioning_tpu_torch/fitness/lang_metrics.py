"""Corpus language metrics for offline evaluation (port of
``nes_img_captioning_tpu/fitness/lang_metrics.py``): BLEU-1..4 and ROUGE-L.

The reference's validation path runs the cococaption submodule's
``COCOEvalCap`` (Java PTBTokenizer + BLEU/METEOR/ROUGE/CIDEr/SPICE —
reference: src/captioning/eval_utils.py:30-57), of which only CIDEr is
consumed by training (``accuracy_on`` returns lang_stats['CIDEr'],
src/captioning/policies.py:130-143). For offline eval parity we provide the
pure-Python computable metrics over token ids (BLEU with corpus-level brevity
penalty and closest-reference length, per Papineni et al. 2002 / the
coco-caption convention; ROUGE-L per Lin 2004 with beta=1.2 as in
coco-caption; METEOR per Banerjee & Lavie 2005 with exact + Porter-stem
matchers, plus optional synonym and paraphrase-phrase matchers when
user-supplied tables are configured — see fitness/meteor.py). SPICE
requires an external
dependency parser + scene-graph models and is intentionally not
reimplemented; ``language_eval`` reports it as None unless a user-provided
external tool is configured (``spice_cmd`` — see ``spice_external``).
"""

from __future__ import annotations

import os
from collections import Counter

import numpy as np

from .ciderd import cut_at_eos

__all__ = ["corpus_bleu", "rouge_l", "language_eval", "spice_external"]


def _tokens(row) -> tuple:
    """Caption tokens (without the trailing EOS 0 — word-level metrics score
    words, and decode_sequence drops everything from the first 0)."""
    t = cut_at_eos(row)
    return t[:-1] if t and t[-1] == 0 else t


def corpus_bleu(cands, gts_list, n_max: int = 4) -> list[float]:
    """BLEU-1..n_max, corpus level, with clipped n-gram precision and the
    closest-reference-length brevity penalty."""
    match = np.zeros(n_max)
    total = np.zeros(n_max)
    c_len, r_len = 0, 0
    for cand, refs in zip(cands, gts_list):
        c = _tokens(cand)
        rs = [_tokens(r) for r in np.asarray(refs)]
        c_len += len(c)
        # closest ref length (ties -> shorter, the coco-caption convention)
        r_len += min((abs(len(r) - len(c)), len(r)) for r in rs)[1]
        for n in range(1, n_max + 1):
            cnt = Counter(tuple(c[i : i + n]) for i in range(len(c) - n + 1))
            if not cnt:
                continue
            max_ref = Counter()
            for r in rs:
                rc = Counter(tuple(r[i : i + n]) for i in range(len(r) - n + 1))
                for g, v in rc.items():
                    if v > max_ref[g]:
                        max_ref[g] = v
            match[n - 1] += sum(min(v, max_ref[g]) for g, v in cnt.items())
            total[n - 1] += sum(cnt.values())
    bp = 1.0 if c_len > r_len else np.exp(1.0 - r_len / max(c_len, 1))
    bleus = []
    logsum = 0.0
    for n in range(n_max):
        p = match[n] / total[n] if total[n] else 0.0
        logsum += np.log(p) if p > 0 else -1e10
        bleus.append(float(bp * np.exp(logsum / (n + 1))))
    return bleus


def _lcs(a: tuple, b: tuple) -> int:
    la, lb = len(a), len(b)
    dp = np.zeros((la + 1, lb + 1), dtype=np.int32)
    for i in range(la):
        for j in range(lb):
            dp[i + 1][j + 1] = (
                dp[i][j] + 1 if a[i] == b[j] else max(dp[i][j + 1], dp[i + 1][j])
            )
    return int(dp[la][lb])


def rouge_l(cands, gts_list, beta: float = 1.2) -> float:
    """Mean ROUGE-L F-beta over candidates, max over references per image."""
    scores = []
    for cand, refs in zip(cands, gts_list):
        c = _tokens(cand)
        best = 0.0
        for r in np.asarray(refs):
            r = _tokens(r)
            if not c or not r:
                continue
            l = _lcs(c, r)
            prec, rec = l / len(c), l / len(r)
            if prec and rec:
                f = ((1 + beta**2) * prec * rec) / (rec + beta**2 * prec)
                best = max(best, f)
        scores.append(best)
    return float(np.mean(scores)) if scores else 0.0


def spice_external(cmd: str, items: list[dict]) -> float | None:
    """Score SPICE through a user-provided external tool (the reference's
    Java scene-graph pipeline, src/captioning/eval_utils.py:49-57 — too
    heavy to ship, so this is a hook for real hosts that have it).

    ``cmd``: a shell command template. ``{input}`` / ``{output}``
    placeholders are substituted with temp-file paths; without placeholders
    the two paths are appended as the final arguments (the SPICE jar's
    ``java -jar spice.jar input.json -out output.json`` fits as
    ``java -jar spice.jar {input} -out {output} -subset``).

    ``items``: ``[{"image_id", "test", "refs": [...]}, ...]`` — the SPICE
    jar's own input schema (string captions).

    Output parsing accepts either the jar's per-image list
    (``[{"image_id", "scores": {"All": {"f": x}}}, ...]`` — mean of the
    All-f scores) or a plain ``{"SPICE": x}`` dict for custom scripts.
    Returns None (with a warning) when the tool fails."""
    import json as _json
    import logging
    import shlex
    import subprocess
    import tempfile

    log = logging.getLogger(__name__)
    with tempfile.TemporaryDirectory(prefix="spice_") as tmp:
        in_path = os.path.join(tmp, "spice_input.json")
        out_path = os.path.join(tmp, "spice_output.json")
        with open(in_path, "w") as f:
            _json.dump(items, f)
        if "{input}" in cmd or "{output}" in cmd:
            argv = [
                a.replace("{input}", in_path).replace("{output}", out_path)
                for a in shlex.split(cmd)
            ]
        else:
            argv = shlex.split(cmd) + [in_path, out_path]
        try:
            subprocess.run(argv, check=True, capture_output=True,
                           timeout=3600)
            with open(out_path) as f:
                out = _json.load(f)
        except (OSError, subprocess.SubprocessError, ValueError) as e:
            detail = getattr(e, "stderr", b"") or b""
            log.warning("spice_cmd failed (%s)%s — reporting SPICE=None", e,
                        f": {detail[-500:].decode(errors='replace')}"
                        if detail else "")
            return None
    try:
        if isinstance(out, dict):
            return float(out["SPICE"]) if "SPICE" in out else None
        scores = [it["scores"]["All"]["f"] for it in out]
        return float(np.mean(scores)) if scores else None
    except (KeyError, TypeError, ValueError) as e:
        log.warning("spice_cmd output had an unexpected shape (%s) — "
                    "reporting SPICE=None", e)
        return None


def language_eval(cands, gts_list, stem_of=None, syn_of=None, para=None,
                  spice_cmd: str | None = None,
                  spice_items: list[dict] | None = None,
                  params15=None) -> dict:
    """COCOEvalCap-shaped metric dict over token ids
    (reference: src/captioning/eval_utils.py:49-57). ``stem_of``: optional
    token -> stem-class mapping (CocoData.word_stem_of) enabling METEOR's
    stage-2 stem matcher; without it METEOR matches exact tokens only.
    ``syn_of``: optional token -> synonym-class-set mapping
    (CocoData.word_syn_of, from caption_options.meteor_synonyms) enabling
    METEOR's stage-3 synonym matcher. ``para``: optional word-id-space
    ParaphraseTable (CocoData.paraphrase_table, from
    caption_options.meteor_paraphrases) enabling METEOR's stage-4 phrase
    matcher. ``spice_cmd`` + ``spice_items`` (string captions, see
    spice_external): score SPICE through an external user-provided tool;
    SPICE is None when unset. ``params15``: optional
    fitness.meteor.Meteor15Params (CocoData.meteor_params, from
    caption_options.meteor_params/meteor_function_words) switching METEOR
    to the 1.5 scoring formulation with function-word weighting."""
    from .meteor import meteor_corpus
    from .scorer import IndexedCiderScorer

    # The aligner gates the phrase stage on truthiness (meteor._align:283);
    # an all-out-of-vocab paraphrase file yields an empty falsy table that
    # never fires — normalize here so the metric note agrees with what ran.
    para = para or None

    bleus = corpus_bleu(cands, gts_list)
    cider = IndexedCiderScorer(gts_list, variant="cider")
    mean_cider, _ = cider.score(np.asarray(cands), np.arange(len(cands)))
    spice = (spice_external(spice_cmd, spice_items)
             if spice_cmd and spice_items is not None else None)
    if params15 is not None:
        stages = "exact+stem" + ("+synonym" if syn_of is not None else "") \
            + ("+paraphrase" if para is not None else "")
        fw = ("with" if params15.func_of is not None else "WITHOUT a") \
            + " function-word list"
        meteor_note = (
            f"METEOR-1.5 scoring formulation (α={params15.alpha}, "
            f"β={params15.beta}, γ={params15.gamma}, δ={params15.delta}, "
            f"stage weights {params15.weights}), {stages} matchers, {fw} "
            "(caption_options.meteor_params/meteor_function_words/"
            "meteor_synonyms/meteor_paraphrases)"
        )
    elif syn_of is not None or para is not None:
        stages = "exact+stem" + ("+synonym" if syn_of is not None else "") \
            + ("+paraphrase" if para is not None else "")
        missing = ([] if syn_of is not None else ["the WordNet synonym "
                                                  "stage"]) \
            + ([] if para is not None else ["a paraphrase table"]) \
            + ["the 1.5 scoring formulation (caption_options.meteor_params)"]
        meteor_note = (
            f"Banerjee-Lavie 2005 with {stages} matchers (user-supplied "
            "tables, caption_options.meteor_synonyms/meteor_paraphrases); "
            f"the reference's Java METEOR-1.5 additionally uses "
            f"{' and '.join(missing)}"
        )
    else:
        meteor_note = (
            "Banerjee-Lavie 2005 (exact+stem matchers); the reference's "
            "Java METEOR-1.5 adds WordNet synonym/paraphrase stages, "
            "absolute values differ by a few points"
        )
    spice_note = (
        "scored via the user-provided spice_cmd external tool"
        if spice is not None else
        "not computed (external Java scene-graph pipeline; absent from the "
        "reference checkout as well). Provide caption_options.spice_cmd / "
        "--spice_cmd to score through a local SPICE jar"
    )
    return {
        "Bleu_1": bleus[0],
        "Bleu_2": bleus[1],
        "Bleu_3": bleus[2],
        "Bleu_4": bleus[3],
        "ROUGE_L": rouge_l(cands, gts_list),
        "CIDEr": float(mean_cider),
        "METEOR": meteor_corpus(cands, gts_list, stem_of, syn_of, para,
                                params15),
        "SPICE": spice,
        # caveats ride along with every score presentation (README metrics
        # table states the same)
        "metric_notes": {"METEOR": meteor_note, "SPICE": spice_note},
    }

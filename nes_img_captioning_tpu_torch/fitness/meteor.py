"""METEOR (port of ``nes_img_captioning_tpu/fitness/meteor.py``; Banerjee &
Lavie 2005): unigram alignment with exact and Porter-stem matchers,
harmonic Fmean, and a fragmentation penalty.

The reference scores METEOR through the cococaption submodule's Java
METEOR-1.5 jar (reference: src/captioning/eval_utils.py:30-57), which adds
WordNet-synonym and paraphrase-table matchers plus function-word weighting —
external model files that do not exist in this offline image. This module
implements the original, fully-specified METEOR formulation instead:

    P = m / len(hyp),  R = m / len(ref)
    Fmean = 10 P R / (R + 9 P)
    penalty = 0.5 * (chunks / m)^3
    score = Fmean * (1 - penalty),   best over the image's references

where ``m`` counts aligned unigrams (stage 1 exact, stage 2 Porter stems on
the remainder, optional stage 3 synonym classes and stage 4 paraphrase
phrases from user-supplied tables — ``load_synonym_table`` /
``load_paraphrase_table``, caption_options.meteor_synonyms /
meteor_paraphrases) and ``chunks`` counts maximal runs of the alignment
that are contiguous in both sentences. Without the tables, absolute values
differ from METEOR-1.5 by a few points; with WordNet/paraphrase-corpus
exports the full METEOR-1.5 matcher cascade is restored.

The METEOR-1.5 SCORING formulation (Denkowski & Lavie 2014) is also
available, opt-in via :class:`Meteor15Params` (caption_options.meteor_params
/ meteor_function_words): parameterized Fmean ``P·R/(α·P+(1−α)·R)``,
penalty ``γ·(ch/m)^β``, per-matcher-stage weights ``w_i``, and
content/function-word weighting ``δ`` over a user-supplied function-word
list. With no params the exactly-specified 2005 formulation above remains
the default. Documented as a deliberate deviation in README.md.

The Porter stemmer below is the 1980 algorithm as published (An algorithm
for suffix stripping, M.F. Porter), verified against the paper's examples in
tests/test_meteor.py.
"""

from __future__ import annotations

import numpy as np

__all__ = ["porter_stem", "meteor", "meteor_corpus", "load_synonym_table",
           "ParaphraseTable", "load_paraphrase_table", "Meteor15Params",
           "load_function_words"]


# ---- Porter stemmer ---------------------------------------------------------------

_VOWELS = "aeiou"


def _is_cons(w: str, i: int) -> bool:
    c = w[i]
    if c in _VOWELS:
        return False
    if c == "y":
        return i == 0 or not _is_cons(w, i - 1)
    return True


def _measure(w: str) -> int:
    """m in the [C](VC)^m[V] decomposition of the stem."""
    n, i, m = len(w), 0, 0
    while i < n and _is_cons(w, i):
        i += 1
    while i < n:
        while i < n and not _is_cons(w, i):
            i += 1
        if i >= n:
            break
        m += 1
        while i < n and _is_cons(w, i):
            i += 1
    return m


def _has_vowel(w: str) -> bool:
    return any(not _is_cons(w, i) for i in range(len(w)))


def _ends_double_cons(w: str) -> bool:
    return len(w) >= 2 and w[-1] == w[-2] and _is_cons(w, len(w) - 1)


def _ends_cvc(w: str) -> bool:
    """*o: stem ends cvc where the final c is not w, x or y."""
    if len(w) < 3:
        return False
    return (
        _is_cons(w, len(w) - 3)
        and not _is_cons(w, len(w) - 2)
        and _is_cons(w, len(w) - 1)
        and w[-1] not in "wxy"
    )


def _replace(w: str, suffix: str, repl: str, min_m: int = 0) -> str | None:
    """stem(w) -> stem+repl when w ends with suffix and measure(stem) > min_m
    (None = rule does not fire)."""
    if not w.endswith(suffix):
        return None
    stem = w[: len(w) - len(suffix)]
    if _measure(stem) > min_m:
        return stem + repl
    return w  # suffix matched but condition failed: later rules don't fire


def porter_stem(word: str) -> str:
    """Porter 1980. Lowercase input expected; words of length <= 2 are
    returned unchanged (the algorithm's convention)."""
    w = word
    if len(w) <= 2:
        return w

    # step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif not w.endswith("ss") and w.endswith("s"):
        w = w[:-1]

    # step 1b
    fired = False
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    elif w.endswith("ed") and _has_vowel(w[:-2]):
        w, fired = w[:-2], True
    elif w.endswith("ing") and _has_vowel(w[:-3]):
        w, fired = w[:-3], True
    if fired:
        if w.endswith(("at", "bl", "iz")):
            w += "e"
        elif _ends_double_cons(w) and not w.endswith(("l", "s", "z")):
            w = w[:-1]
        elif _measure(w) == 1 and _ends_cvc(w):
            w += "e"

    # step 1c
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"

    # step 2 (m > 0 suffix swaps, longest-match by construction of the scan)
    for suf, rep in (
        ("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
        ("anci", "ance"), ("izer", "ize"), ("abli", "able"), ("alli", "al"),
        ("entli", "ent"), ("eli", "e"), ("ousli", "ous"), ("ization", "ize"),
        ("ation", "ate"), ("ator", "ate"), ("alism", "al"), ("iveness", "ive"),
        ("fulness", "ful"), ("ousness", "ous"), ("aliti", "al"),
        ("iviti", "ive"), ("biliti", "ble"),
    ):
        out = _replace(w, suf, rep)
        if out is not None:
            w = out
            break

    # step 3
    for suf, rep in (
        ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
        ("ical", "ic"), ("ful", ""), ("ness", ""),
    ):
        out = _replace(w, suf, rep)
        if out is not None:
            w = out
            break

    # step 4 (m > 1 suffix deletion)
    for suf in (
        "al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
        "ment", "ent", "ion", "ou", "ism", "ate", "iti", "ous", "ive", "ize",
    ):
        if w.endswith(suf):
            stem = w[: len(w) - len(suf)]
            if suf == "ion" and not stem.endswith(("s", "t")):
                break  # (*S or *T) condition for -ion
            if _measure(stem) > 1:
                w = stem
            break

    # step 5a
    if w.endswith("e"):
        m = _measure(w[:-1])
        if m > 1 or (m == 1 and not _ends_cvc(w[:-1])):
            w = w[:-1]
    # step 5b
    if _measure(w) > 1 and _ends_double_cons(w) and w.endswith("l"):
        w = w[:-1]
    return w


# ---- METEOR alignment + score ------------------------------------------------------


def _align(hyp: list, ref: list, stem_of=None, syn_of=None,
           para=None) -> list[tuple[tuple[int, int], tuple[int, int]]]:
    """Matcher-cascade alignment: exact tokens, then stems, then synonyms,
    then paraphrase phrases over the residue (the METEOR-1.5 cascade order).
    Within a unigram stage each hypothesis position (left to right) takes
    the nearest unmatched reference position — the standard greedy
    approximation of METEOR's fewest-crossings tie-break.

    Returns SPAN triples ``((h_start, h_len), (r_start, r_len), stage)``
    sorted by hypothesis position, where ``stage`` is the canonical matcher
    index (0 exact, 1 stem, 2 synonym, 3 paraphrase — the METEOR-1.5
    weight order); the unigram stages produce length-1 spans, the
    paraphrase stage whole-phrase spans (possibly of unequal lengths).

    ``syn_of``: token -> set of synonym-class ids (e.g. WordNet synsets);
    two tokens match when their class sets intersect — a word belongs to
    several synsets, so class equality would be too strict.

    ``para``: a :class:`ParaphraseTable` in the caller's token space; a
    hypothesis phrase matches a reference phrase when their class sets
    intersect and every covered position is still unmatched. Greedy rule
    (documented, deterministic): scan hypothesis starts left to right,
    prefer the longest matchable hypothesis span, then the reference span
    with the nearest start (leftmost on ties, longest at that start)."""
    matched_r = [False] * len(ref)
    spans: list[tuple[tuple[int, int], tuple[int, int], int]] = []
    matched_h = [False] * len(hyp)

    def stage(key_h, key_r, hit, sid):
        for i, kh in enumerate(key_h):
            if matched_h[i]:
                continue
            best, best_d = -1, None
            for j, kr in enumerate(key_r):
                if matched_r[j] or not hit(kh, kr):
                    continue
                d = abs(i - j)
                if best_d is None or d < best_d:
                    best, best_d = j, d
            if best >= 0:
                matched_h[i] = True
                matched_r[best] = True
                spans.append(((i, 1), (best, 1), sid))

    def stage_paraphrase(ptab):
        i = 0
        while i < len(hyp):
            if matched_h[i]:
                i += 1
                continue
            chosen = None
            for L in range(min(ptab.max_len, len(hyp) - i), 0, -1):
                if any(matched_h[i:i + L]):
                    continue
                ch = ptab.classes(hyp[i:i + L])
                if not ch:
                    continue
                best = None  # ((distance, j), j, M)
                for j in range(len(ref)):
                    for M in range(min(ptab.max_len, len(ref) - j), 0, -1):
                        if any(matched_r[j:j + M]):
                            continue
                        cr = ptab.classes(ref[j:j + M])
                        if cr and (ch & cr):
                            key = (abs(i - j), j)
                            if best is None or key < best[0]:
                                best = (key, j, M)
                            break  # longest M at this j; shorter adds nothing
                if best is not None:
                    chosen = (L, best[1], best[2])
                    break  # longest hypothesis span wins
            if chosen is None:
                i += 1
                continue
            L, j, M = chosen
            for k in range(L):
                matched_h[i + k] = True
            for k in range(M):
                matched_r[j + k] = True
            spans.append(((i, L), (j, M), 3))
            i += L

    eq = lambda a, b: a == b  # noqa: E731
    stage(hyp, ref, eq, 0)
    if stem_of is not None:
        stage([stem_of(t) for t in hyp], [stem_of(t) for t in ref], eq, 1)
    if syn_of is not None:
        stage([syn_of(t) for t in hyp], [syn_of(t) for t in ref],
              lambda a, b: bool(a and b and (a & b)), 2)
    if para:
        stage_paraphrase(para)
    return sorted(spans)


def _chunks(spans) -> int:
    """Maximal runs contiguous in both sentences (spans sorted by hyp pos):
    a run continues when the next span starts exactly where the previous one
    ended on BOTH sides — for length-1 spans this is the classic adjacent-
    pair rule; a matched phrase pair is contiguous by construction."""
    if not spans:
        return 0
    n = 1
    for ((h1, hl), (r1, rl), _s1), ((h2, _), (r2, _), _s2) in zip(
            spans, spans[1:]):
        if h2 != h1 + hl or r2 != r1 + rl:
            n += 1
    return n


class Meteor15Params:
    """METEOR-1.5 scoring parameters (Denkowski & Lavie 2014). Defaults are
    the tuned English values of the reference's Java METEOR-1.5 jar
    (reference: src/captioning/eval_utils.py:30-57):

      * ``alpha`` — precision/recall balance in
        ``Fmean = P·R / (α·P + (1−α)·R)``;
      * ``beta``, ``gamma`` — fragmentation penalty ``γ·(ch/m)^β`` with
        ``m`` the mean of hypothesis- and reference-side matched unigrams;
      * ``weights`` — per-matcher-stage match weights in cascade order
        (exact, stem, synonym, paraphrase);
      * ``func_of`` — optional token -> bool predicate marking FUNCTION
        words; content words weigh ``δ``, function words ``1−δ`` in the
        weighted precision/recall. ``None`` treats every token as a content
        word, where δ cancels (the no-function-word-list behavior).

    Absolute parity with the jar additionally requires its bundled
    function-word list / WordNet / paraphrase data (user-supplied here via
    caption_options.meteor_function_words / meteor_synonyms /
    meteor_paraphrases)."""

    def __init__(self, alpha: float = 0.85, beta: float = 0.2,
                 gamma: float = 0.6, delta: float = 0.75,
                 weights: tuple = (1.0, 0.6, 0.8, 0.6), func_of=None):
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.gamma = float(gamma)
        self.delta = float(delta)
        self.weights = tuple(float(w) for w in weights)
        if len(self.weights) != 4:
            raise ValueError(
                f"meteor weights must give all 4 cascade stages "
                f"(exact, stem, synonym, paraphrase), got {weights!r}")
        self.func_of = func_of


def _score15(spans, hyp, ref, p15: Meteor15Params) -> float:
    """METEOR-1.5 score of one alignment: stage-weighted, function-word-
    weighted precision/recall, parameterized Fmean and penalty."""
    delta = p15.delta
    wt = ((lambda t: 1.0 - delta if p15.func_of(t) else delta)
          if p15.func_of is not None else (lambda t: delta))
    den_h = sum(wt(t) for t in hyp)
    den_r = sum(wt(t) for t in ref)
    mw_h = mw_r = 0.0
    m_h = m_r = 0
    for (h1, hl), (r1, rl), sid in spans:
        w = p15.weights[sid]
        mw_h += w * sum(wt(t) for t in hyp[h1:h1 + hl])
        mw_r += w * sum(wt(t) for t in ref[r1:r1 + rl])
        m_h += hl
        m_r += rl
    if m_h == 0 or den_h <= 0.0 or den_r <= 0.0:
        return 0.0
    p = mw_h / den_h
    r = mw_r / den_r
    if p == 0.0 or r == 0.0:
        return 0.0
    fmean = p * r / (p15.alpha * p + (1.0 - p15.alpha) * r)
    frag = _chunks(spans) / ((m_h + m_r) / 2.0)
    return fmean * (1.0 - p15.gamma * frag ** p15.beta)


def meteor(hyp, refs, stem_of=None, syn_of=None, para=None,
           params15: Meteor15Params | None = None) -> float:
    """METEOR score of one hypothesis against its references (best ref).

    hyp: token sequence; refs: list of token sequences. Tokens may be ints
    (word ids) or strings. ``stem_of``: optional token -> stem-class mapping
    enabling the stage-2 stem matcher. ``syn_of``: optional token ->
    synonym-class-id set enabling the stage-3 synonym matcher (the
    reference METEOR-1.5's WordNet stage, given user-supplied synonym data —
    caption_options.meteor_synonyms). ``para``: optional
    :class:`ParaphraseTable` enabling the stage-4 phrase matcher
    (caption_options.meteor_paraphrases). ``params15``: optional
    :class:`Meteor15Params` switching the SCORING from the 2005 formulation
    to METEOR-1.5's (caption_options.meteor_params).

    With phrase matches the matched mass can differ per side: precision
    counts hypothesis words covered (m_h), recall reference words covered
    (m_r); the 2005 fragmentation penalty uses m_h (METEOR's "matched
    unigrams" are counted in the hypothesis). For unigram-only alignments
    m_h == m_r == m, the exact 2005 formulation."""
    hyp = list(hyp)
    best = 0.0
    for ref in refs:
        ref = list(ref)
        if not hyp or not ref:
            continue
        spans = _align(hyp, ref, stem_of, syn_of, para)
        if params15 is not None:
            best = max(best, _score15(spans, hyp, ref, params15))
            continue
        m_h = sum(hl for (_, hl), _, _ in spans)
        m_r = sum(rl for _, (_, rl), _ in spans)
        if m_h == 0:
            continue
        p = m_h / len(hyp)
        r = m_r / len(ref)
        fmean = 10.0 * p * r / (r + 9.0 * p)
        penalty = 0.5 * (_chunks(spans) / m_h) ** 3
        best = max(best, fmean * (1.0 - penalty))
    return best


def _strip_eos(row) -> list:
    out = []
    for t in np.asarray(row).tolist():
        if t == 0:
            break
        out.append(t)
    return out


def meteor_corpus(cands, gts_list, stem_of=None, syn_of=None,
                  para=None, params15: Meteor15Params | None = None) -> float:
    """Mean METEOR over (candidate row, reference rows) pairs of int token
    rows (0-terminated, the framework's caption layout)."""
    scores = [
        meteor(_strip_eos(c), [_strip_eos(r) for r in np.asarray(refs)],
               stem_of, syn_of, para, params15)
        for c, refs in zip(cands, gts_list)
    ]
    return float(np.mean(scores)) if scores else 0.0


class ParaphraseTable:
    """Phrase (token tuple) -> paraphrase-class-id frozenset, with the max
    phrase length cached for the aligner's span search. Token space is the
    caller's (word strings from :func:`load_paraphrase_table`; word ids
    after CocoData.paraphrase_table maps it into scoring space)."""

    def __init__(self, table: dict):
        self.table = {tuple(k): frozenset(v) for k, v in table.items()}
        self.max_len = max((len(k) for k in self.table), default=0)

    def classes(self, phrase):
        return self.table.get(tuple(phrase))

    def __bool__(self) -> bool:
        return bool(self.table)

    def __len__(self) -> int:
        return len(self.table)


def load_synonym_table(path: str) -> dict[str, frozenset]:
    """User-supplied synonym data -> word -> synonym-class-id set.

    Accepted JSON formats (chosen so a WordNet dump is a trivial export):
      * a list of synonym groups: ``[["car","auto"], ["kid","child"]]``
        (group index = class id);
      * a dict word -> class id(s): ``{"car": [3, 7], "auto": 3}``.
    Words are lowercased. A word may belong to several classes; METEOR's
    synonym matcher fires on any shared class."""
    import json

    with open(path) as f:
        spec = json.load(f)
    table: dict[str, set] = {}
    if isinstance(spec, list):
        for gid, group in enumerate(spec):
            for w in group:
                table.setdefault(str(w).lower(), set()).add(gid)
    elif isinstance(spec, dict):
        for w, gids in spec.items():
            ids = gids if isinstance(gids, (list, tuple)) else [gids]
            table.setdefault(str(w).lower(), set()).update(int(g) for g in ids)
    else:
        raise ValueError(
            f"synonym table {path}: expected a JSON list of groups or a "
            f"word->class dict, got {type(spec).__name__}"
        )
    return {w: frozenset(s) for w, s in table.items()}


def load_paraphrase_table(path: str) -> ParaphraseTable:
    """User-supplied paraphrase data -> :class:`ParaphraseTable` over word
    strings (the reference Java METEOR-1.5's paraphrase-table stage, given
    equivalent data — e.g. an export of its ``paraphrase-en.gz``).

    Accepted JSON formats (mirroring load_synonym_table):
      * a list of paraphrase groups of phrase strings:
        ``[["kid jumped", "child leaped"], ["sofa", "couch"]]``
        (group index = class id; a pair is just a 2-element group);
      * a dict phrase -> class id(s): ``{"kid jumped": 0, "child leaped": [0]}``.
    Phrases are lowercased and whitespace-tokenized; single-word phrases are
    allowed (they fire only on the residue the earlier matchers left)."""
    import json

    with open(path) as f:
        spec = json.load(f)
    table: dict[tuple, set] = {}

    def add(phrase, gid):
        words = tuple(str(phrase).lower().split())
        if words:
            table.setdefault(words, set()).add(int(gid))

    if isinstance(spec, list):
        for gid, group in enumerate(spec):
            for phrase in group:
                add(phrase, gid)
    elif isinstance(spec, dict):
        for phrase, gids in spec.items():
            for g in (gids if isinstance(gids, (list, tuple)) else [gids]):
                add(phrase, g)
    else:
        raise ValueError(
            f"paraphrase table {path}: expected a JSON list of phrase groups "
            f"or a phrase->class dict, got {type(spec).__name__}"
        )
    return ParaphraseTable(table)


def load_function_words(path: str) -> frozenset:
    """User-supplied function-word list -> lowercased word frozenset, for
    METEOR-1.5's δ weighting (an export of the jar's ``function/en.words``
    is one word per line). Accepted formats: a JSON list of words, or a
    plain text file with one word per line (``#`` comments ignored)."""
    import json

    with open(path) as f:
        text = f.read()
    try:
        spec = json.loads(text)
    except ValueError:
        spec = [ln.strip() for ln in text.splitlines()
                if ln.strip() and not ln.lstrip().startswith("#")]
    if not isinstance(spec, list):
        raise ValueError(
            f"function-word list {path}: expected a JSON list of words or "
            f"one word per line, got {type(spec).__name__}")
    return frozenset(str(w).lower() for w in spec)

"""The port's language metrics against the JAX package's, on the same
seeded inputs: BLEU, ROUGE-L, METEOR (every matcher stage, the 1.5
formulation), the Porter stemmer, the three table loaders, the SPICE hook
with a stand-in tool, ``language_eval``, and ``CocoData``'s METEOR tables in
word-id space. Both sides are plain Python over the same numbers, so every
score must be the same float; CIDEr goes through each package's native
scorer (the same C++ source, built apart), within 1e-9."""

import json
import sys

import numpy as np
import pytest

from nes_img_captioning_tpu.data.synthetic import make_synthetic_coco
from nes_img_captioning_tpu.fitness import lang_metrics as jlm
from nes_img_captioning_tpu.fitness import meteor as jmet
from nes_img_captioning_tpu_torch.fitness import lang_metrics as tlm
from nes_img_captioning_tpu_torch.fitness import meteor as tmet

from torch_pin import one_intra_op_thread  # noqa: F401

# words whose Porter stems collide, so the stem stage has work to do
WORDS = ["cat", "cats", "dog", "dogs", "running", "runs", "sitting", "sits",
         "the", "a", "on", "mat", "sofa", "couch", "kid", "child", "jumped",
         "leaped", "happy", "happiness"]
SYNONYMS = [["sofa", "couch"], ["kid", "child"], ["jumped", "leaped"]]
PARAPHRASES = [["kid jumped", "child leaped"], ["on the mat", "on a sofa"],
               ["happy", "happiness"]]
FUNCTION_WORDS = ["the", "a", "on"]


def _rows(rng, n, vocab, T=12):
    """n 0-terminated token rows of 1..T-1 tokens in 1..vocab."""
    out = np.zeros((n, T), np.int32)
    for i in range(n):
        k = rng.integers(1, T)
        out[i, :k] = rng.integers(1, vocab + 1, size=k)
    return out


def _corpus(seed, n=40, vocab=9):
    """Candidates (n, T) and per-image reference rows (1-5 each) over a
    small vocab, so n-grams overlap."""
    rng = np.random.default_rng(seed)
    cands = _rows(rng, n, vocab)
    gts = [_rows(rng, int(rng.integers(1, 6)), vocab) for _ in range(n)]
    return cands, gts


def _sentences(seed, n=30):
    rng = np.random.default_rng(seed)
    sent = lambda: [WORDS[i] for i in rng.integers(  # noqa: E731
        0, len(WORDS), size=rng.integers(1, 9))]
    return [(sent(), [sent() for _ in range(rng.integers(1, 4))])
            for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bleu_and_rouge_equal_jax(seed):
    cands, gts = _corpus(seed)
    assert tlm.corpus_bleu(cands, gts) == jlm.corpus_bleu(cands, gts)
    assert tlm.rouge_l(cands, gts) == jlm.rouge_l(cands, gts)


def _tables(mod, tmp_path):
    """(stem_of, syn_of, para, params15) of one package over word strings,
    from its own loaders."""
    syn_path = tmp_path / "syn.json"
    para_path = tmp_path / "para.json"
    fw_path = tmp_path / "fw.txt"
    syn_path.write_text(json.dumps(SYNONYMS))
    para_path.write_text(json.dumps(PARAPHRASES))
    fw_path.write_text("\n".join(FUNCTION_WORDS))
    syn = mod.load_synonym_table(str(syn_path))
    fwords = mod.load_function_words(str(fw_path))
    return (mod.porter_stem, syn.get,
            mod.load_paraphrase_table(str(para_path)),
            mod.Meteor15Params(func_of=lambda w: w in fwords))


@pytest.mark.parametrize("stages", ["exact", "stem", "synonym", "paraphrase",
                                    "meteor15"])
@pytest.mark.parametrize("seed", [0, 1])
def test_meteor_stages_equal_jax(tmp_path, stages, seed):
    """meteor() of each sentence, one matcher stage more per case, and the
    1.5 formulation with function-word weighting over all four."""
    order = ["exact", "stem", "synonym", "paraphrase", "meteor15"]
    on = order[:order.index(stages) + 1]

    def args(mod):
        stem, syn, para, p15 = _tables(mod, tmp_path)
        return (stem if "stem" in on else None,
                syn if "synonym" in on else None,
                para if "paraphrase" in on else None,
                p15 if "meteor15" in on else None)

    ja, ta = args(jmet), args(tmet)
    scores = []
    for hyp, refs in _sentences(seed):
        want = jmet.meteor(hyp, refs, *ja)
        assert tmet.meteor(hyp, refs, *ta) == want
        scores.append(want)
    assert 0.0 < max(scores) <= 1.0


@pytest.mark.parametrize("params15", [False, True])
def test_meteor_corpus_equal_jax(params15):
    cands, gts = _corpus(3)
    stem = lambda t: t % 5  # noqa: E731  (a stem class per token id)
    want = jmet.meteor_corpus(cands, gts, stem, None, None,
                              jmet.Meteor15Params() if params15 else None)
    got = tmet.meteor_corpus(cands, gts, stem, None, None,
                             tmet.Meteor15Params() if params15 else None)
    assert got == want and want > 0


def test_porter_stem_equal_jax():
    """The stemmer over English words and seeded suffixed strings."""
    rng = np.random.default_rng(0)
    stems = ["connect", "generat", "hop", "plaster", "rat", "condit", "sky",
             "feed", "troubl", "formal", "electr", "adopt", "happi"]
    suffixes = ["", "s", "es", "ies", "ed", "ing", "ational", "tional",
                "izer", "ization", "ness", "ful", "ement", "ly", "e", "y",
                "ion", "ance", "ive", "ize", "ate", "iti", "al", "ll"]
    words = WORDS + [stems[i] + suffixes[j] for i, j in zip(
        rng.integers(0, len(stems), 400), rng.integers(0, len(suffixes),
                                                       400))]
    assert [tmet.porter_stem(w) for w in words] == \
        [jmet.porter_stem(w) for w in words]


@pytest.mark.parametrize("fmt", ["list", "dict"])
def test_table_loaders_equal_jax(tmp_path, fmt):
    """load_synonym_table, load_paraphrase_table and load_function_words
    read both accepted formats as the JAX package does."""
    if fmt == "list":
        syn, para, fw = SYNONYMS, PARAPHRASES, json.dumps(FUNCTION_WORDS)
    else:
        syn = {"sofa": [3, 7], "couch": 3, "Kid": 1}
        para = {"kid jumped": 0, "Child Leaped": [0, 2]}
        fw = "# function words\nthe\n A \non\n"
    (tmp_path / "s.json").write_text(json.dumps(syn))
    (tmp_path / "p.json").write_text(json.dumps(para))
    (tmp_path / "f.txt").write_text(fw)
    s, p, f = (str(tmp_path / n) for n in ("s.json", "p.json", "f.txt"))
    assert tmet.load_synonym_table(s) == jmet.load_synonym_table(s)
    tp, jp = tmet.load_paraphrase_table(p), jmet.load_paraphrase_table(p)
    assert tp.table == jp.table and tp.max_len == jp.max_len
    assert tmet.load_function_words(f) == jmet.load_function_words(f)


ITEMS = [{"image_id": 1, "test": "a cat", "refs": ["a cat", "the cat"]},
         {"image_id": 2, "test": "a dog", "refs": ["a dog"]}]


@pytest.mark.parametrize("body,template", [
    ("items = json.load(open(sys.argv[1]))\n"
     "json.dump([{'image_id': it['image_id'], 'scores': {'All': {'f': "
     "0.25 + 0.5 * i}}} for i, it in enumerate(items)], "
     "open(sys.argv[2], 'w'))\n", ""),
    ("json.dump({'SPICE': 0.125}, open(sys.argv[2], 'w'))\n",
     " {input} {output}"),
    ("sys.exit(3)\n", ""),
    ("open(sys.argv[2], 'w').write('not json')\n", ""),
], ids=["jar_format", "placeholders", "fails", "garbage"])
def test_spice_external_equal_jax(tmp_path, body, template):
    """The SPICE hook with a stand-in tool (no jar): the same score, or
    None for a failing or garbled tool, as the JAX package."""
    tool = tmp_path / "fake_spice.py"
    tool.write_text("import json, sys\n" + body)
    cmd = f"{sys.executable} {tool}" + template
    want = jlm.spice_external(cmd, ITEMS)
    assert tlm.spice_external(cmd, ITEMS) == want


@pytest.mark.parametrize("seed", [0, 1])
def test_language_eval_equal_jax(seed):
    """BLEU, ROUGE-L and METEOR the same floats; CIDEr within 1e-9 (each
    package's native scorer); the notes the same."""
    cands, gts = _corpus(seed)
    stem = lambda t: t % 4  # noqa: E731
    want = jlm.language_eval(cands, gts, stem_of=stem)
    got = tlm.language_eval(cands, gts, stem_of=stem)
    assert set(got) == set(want)
    for k in ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "ROUGE_L", "METEOR",
              "SPICE", "metric_notes"):
        assert got[k] == want[k], k
    assert got["CIDEr"] == pytest.approx(want["CIDEr"], rel=0, abs=1e-9)
    assert want["CIDEr"] > 0


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    """A synthetic fixture whose vocab has case variants (token 4 is token
    1's word upper-cased, token 5 token 2's), with METEOR tables over its
    words."""
    d = tmp_path_factory.mktemp("coco_meteor")
    copts = make_synthetic_coco(str(d), n_train=8, n_val=8, n_test=12,
                                vocab_size=20, fc_feat_size=16, cap_len=5)
    info = json.load(open(copts["input_json"]))
    w = info["ix_to_word"]
    w["4"], w["5"] = w["1"].upper(), w["2"].upper()
    with open(copts["input_json"], "w") as f:
        json.dump(info, f)
    (d / "syn.json").write_text(json.dumps([[w["1"], w["3"]],
                                            [w["2"], w["6"], w["7"]]]))
    (d / "para.json").write_text(json.dumps(
        [[f"{w['1']} {w['2']}", w["8"]], [w["9"], f"{w['10']} {w['11']}"],
         ["notaword", w["1"]]]))
    (d / "fw.txt").write_text(f"{w['2']}\n{w['12']}\n")
    return dict(copts, meteor_synonyms=str(d / "syn.json"),
                meteor_paraphrases=str(d / "para.json"),
                meteor_params={"alpha": 0.8},
                meteor_function_words=str(d / "fw.txt"))


def test_coco_meteor_tables_equal_jax(coco):
    """CocoData's word-id tables (stems, synonym classes, the paraphrase
    table with its case variants, the 1.5 params with function words) as
    the JAX package builds them, and language_eval on the test split
    through them: every score the same float but CIDEr (1e-9)."""
    from nes_img_captioning_tpu.data.mscoco import CocoData as JData
    from nes_img_captioning_tpu_torch.data.mscoco import CocoData

    jd, td = JData(coco), CocoData(coco)
    wids = np.arange(1, td.vocab_size + 1)
    assert np.array_equal(td._vocab_wids(), jd._vocab_wids())
    for wid in np.unique(td._vocab_wids()).tolist():
        assert td.word_stem_of(wid) == jd.word_stem_of(wid)
        assert td.word_syn_of(wid) == jd.word_syn_of(wid)
    assert td.has_synonym_table() and jd.has_synonym_table()
    assert td.paraphrase_table().table == jd.paraphrase_table().table
    tp, jp = td.meteor_params(), jd.meteor_params()
    assert (tp.alpha, tp.beta, tp.gamma, tp.delta, tp.weights) == \
        (jp.alpha, jp.beta, jp.gamma, jp.delta, jp.weights)
    assert [tp.func_of(int(w)) for w in wids] == \
        [jp.func_of(int(w)) for w in wids]

    rng = np.random.default_rng(0)
    gts = td.split_gts("test")
    cands = _rows(rng, len(gts), td.vocab_size, T=td.seq_length)
    outs = [lang.language_eval(
        d.word_id_rows(cands), [d.word_id_rows(g) for g in gts],
        stem_of=d.word_stem_of, syn_of=d.word_syn_of,
        para=d.paraphrase_table(), params15=d.meteor_params())
        for lang, d in ((tlm, td), (jlm, jd))]
    got, want = outs
    for k in ("Bleu_1", "Bleu_4", "ROUGE_L", "METEOR", "metric_notes"):
        assert got[k] == want[k], k
    assert got["CIDEr"] == pytest.approx(want["CIDEr"], rel=0, abs=1e-9)

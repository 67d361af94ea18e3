"""The ring-shape sweep's constant rewrite (``scripts/torch_pair_tiles.py``)
on the committed kernel source: a bare name sets a ``pair::`` constant,
``member.NAME`` a ``member::`` one, ``wpair.NAME`` and ``wmember.NAME``
one of the wide pair or member kernel's, and nothing else in the file
moves."""

import importlib.util
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "torch_pair_tiles", ROOT / "scripts" / "torch_pair_tiles.py")
tiles = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tiles)
SRC = (ROOT / "nes_img_captioning_tpu_torch" / "csrc" / "decode.cu"
       ).read_text()


def _constants(text: str, ns: str) -> dict:
    start = text.index(f"namespace {ns} {{")
    end = text.index(f"}}  // namespace {ns}", start)
    return dict(re.findall(r"constexpr int (\w+) = (\d+);", text[start:end]))


def _namespace(key: str) -> tuple:
    return tuple(key.split(".")) if "." in key else ("pair", key)


@pytest.mark.parametrize("values", [
    {"KT": "32", "MAXNS": "6"},
    {"member.KT": "64", "member.MAXNS": "8"},
    {"member.AHEAD_MAX": "2", "AHEAD_MAX": "3", "member.KT": "32"},
    {"member.GUMBEL_SKIP": "0"},
    {"member.GUMBEL_COUNT": "1", "member.KT": "64"},
    {"wpair.TILE": "2048", "wpair.TKL": "32", "wpair.MAXNS": "8"},
    {"wpair.AT_128": "1", "KT": "32"},
    {"wmember.TILE": "4096", "wmember.TKL": "64", "wmember.MAXNS": "6"},
    {"wmember.AT_128": "1", "member.KT": "64"},
], ids=["pair", "member", "both", "k3_no_skip", "k3_count", "wide_pair",
        "wide_pair_at_128", "wide_member", "wide_member_at_128"])
def test_rewrite_sets_each_constant_in_its_namespace(values):
    out = tiles.rewrite(SRC, values)
    for ns in ("pair", "member", "wpair", "wmember"):
        want = {name: v for key, v in values.items()
                for n, name in [_namespace(key)] if n == ns}
        before, after = _constants(SRC, ns), _constants(out, ns)
        assert {k for k in before if before[k] != after[k]} <= set(want)
        assert all(after[name] == v for name, v in want.items())
    # outside the two namespaces the text is unchanged
    strip = [re.sub(r"constexpr int \w+ = \d+;", "", t) for t in (SRC, out)]
    assert strip[0] == strip[1]


@pytest.mark.parametrize("key", ["member.NSLOT", "member.KPW", "LDB",
                                 "member.THREADS", "member.SWIZZLE",
                                 "GUMBEL_SKIP", "wpair.KT", "wpair.GW",
                                 "wmember.KT", "wmember.GW"])
def test_rewrite_refuses_a_constant_its_namespace_lacks(key):
    with pytest.raises(ValueError, match="not defined once"):
        tiles.rewrite(SRC, {key: "3"})

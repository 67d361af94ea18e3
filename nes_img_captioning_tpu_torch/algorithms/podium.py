"""Hall of fame for the E best individuals ever evaluated (a copy of
``nes_img_captioning_tpu/algorithms/podium.py``).

Behavioral spec (reference: src/algorithm/tools/podium.py — reimplemented,
not transcribed):

* the scoreboard holds ``num_elites`` (path, score) slots, seeded empty;
* merging this generation's candidates keeps the top E by score, with
  incumbents winning ties (so a tie never counts as an improvement);
* every slot's file lives at ``<dir>/best_elite/0_{rank}_elite.pth`` — the
  on-disk layout resumes and offline eval expect — and the directory is
  pruned down to exactly the live slots;
* the patience counter upstream is fed by whether any *new* file landed on
  the scoreboard since it last asked (``is_bad_generation`` reads and rearms
  the flag).
"""

from __future__ import annotations

import logging
import os

from ..utils.files import copy_file_from_to, mkdir_p, remove_all_files_but

logger = logging.getLogger(__name__)

__all__ = ["Podium"]

_EMPTY_SLOT = ("", float("-inf"))


class Podium:
    SLOT_NAME = "0_{rank}_elite.pth"

    def __init__(self, patience, directory: str, num_elites: int):
        # ``patience`` is accepted for call-site parity but the annealing
        # decision lives in Iteration; the podium only reports improvement
        del patience
        self._capacity = num_elites
        self._slots: list[tuple[str, float]] = [_EMPTY_SLOT] * num_elites
        self._dir = mkdir_p(os.path.join(directory, "best_elite"))
        # rearmed by is_bad_generation(); set whenever a candidate file is
        # actually copied onto the scoreboard
        self._entered_since_check = False

    def _slot_path(self, rank: int) -> str:
        return os.path.join(self._dir, self.SLOT_NAME.format(rank=rank))

    def _pad(self, slots: list) -> list:
        """The scoreboard ALWAYS holds exactly ``capacity`` entries (unfilled
        = _EMPTY_SLOT): callers like NESMaster._podium_would_take decide
        whether a score would enter by looking at the slots, so a shrunken
        list would make a below-capacity scoreboard look full."""
        return slots + [_EMPTY_SLOT] * (self._capacity - len(slots))

    def init_from_infos(self, infos: dict):
        """Resume: re-home every checkpointed elite file into this run's
        slot layout (scores carry over verbatim; checkpoints store only the
        filled slots)."""
        restored = []
        for rank, (src, score) in enumerate(infos["best_elites"]):
            dst = self._slot_path(rank)
            copy_file_from_to(src, dst)
            restored.append((dst, score))
        self._slots = self._pad(restored)

    def record_elites(self, elites_and_scores):
        """Merge candidates into the scoreboard. Stable sort with incumbents
        listed first = ties keep the incumbent."""
        ranking = sorted(
            list(self._slots) + list(elites_and_scores),
            key=lambda entry: entry[1], reverse=True,
        )

        # Two phases: stage every moving file under a temp name, then rename
        # into the slots. Deliberate deviation from the reference, which
        # copies directly into slot files in rank order and therefore feeds a
        # demoted incumbent the NEW rank-0 file's bytes (slot content
        # corruption on every rank shift).
        survivors: list[tuple[str, float]] = []
        staged: list[tuple[str, str]] = []
        for src, score in ranking[: self._capacity]:
            if not src:
                continue  # unfilled seed slot
            dst = self._slot_path(len(survivors))
            if src != dst:
                tmp = dst + ".staging"
                try:
                    copy_file_from_to(src, tmp)
                    staged.append((tmp, dst))
                    self._entered_since_check = True
                except OSError:
                    # candidate file vanished between eval and merge — keep
                    # the scoreboard entry (matches reference semantics) but
                    # it does not count as an improvement
                    logger.error(
                        "podium: candidate file %s disappeared before it "
                        "could be archived", src,
                    )
            survivors.append((dst, score))
        for tmp, dst in staged:
            os.replace(tmp, dst)

        self._slots = self._pad(survivors)
        remove_all_files_but(self._dir, [p for p, _ in survivors])

    def install_merged(self, scores, rows, save_row):
        """Install an EXTERNALLY merged scoreboard (the ES blocked path
        merges the podium on device with record_elites' exact semantics —
        stable desc sort, incumbents win ties — inside the K-generation
        program). ``scores`` are the post-merge slot scores best-first,
        ``rows`` the matching theta rows, ``save_row(row, path)`` writes one
        slot file. Files are staged then renamed, like record_elites."""
        staged = []
        slots = []
        for rank, score in enumerate(scores):
            dst = self._slot_path(rank)
            tmp = dst + ".staging"
            save_row(rows[rank], tmp)
            staged.append((tmp, dst))
            slots.append((dst, float(score)))
        for tmp, dst in staged:
            os.replace(tmp, dst)
        self._entered_since_check = True
        self._slots = self._pad(slots)
        remove_all_files_but(self._dir, [p for p, _ in slots])

    def adopt_scores(self, scores):
        """Adopt externally merged slot SCORES without touching slot files
        (the ES blocked path keeps the merged elite rows device-resident and
        defers the ~35 MB row pull + file writes until a consumer actually
        reads the files — snapshot, per-generation handoff, resume). The
        caller (ESMaster._materialize_podium) OWNS the discipline that slot
        files are rewritten via install_merged before any read; between
        blocks the on-disk bytes are stale."""
        self._entered_since_check = True
        self._slots = self._pad(
            [(self._slot_path(rank), float(s))
             for rank, s in enumerate(scores)]
        )

    def is_bad_generation(self) -> bool:
        """True iff nothing new landed on the scoreboard since the last
        call. Reading rearms the flag (one answer per generation)."""
        improved = self._entered_since_check
        self._entered_since_check = False
        logger.info("podium %s this generation",
                    "improved" if improved else "unchanged")
        return not improved

    def best_elites(self) -> list[tuple[str, float]]:
        return self._slots

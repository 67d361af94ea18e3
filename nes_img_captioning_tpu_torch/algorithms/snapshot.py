"""Checkpoint writer: the reference's z_info JSON format
(reference: src/algorithm/tools/snapshot.py:14-38); a copy of
``nes_img_captioning_tpu/algorithms/snapshot.py``.

One ``z_info_e{epoch}_i{iter}-{trainloader_lth}.json`` per snapshot dir
(previous one deleted), merging stats + iteration + experiment dicts. The
JSON references .pth/.tar artifacts on disk — together they are the resumable
checkpoint, loadable by ``from_infos`` here or in the reference.
"""

from __future__ import annotations

import json
import logging
import os

from ..utils.files import mkdir_p, remove_file_with_pattern

logger = logging.getLogger(__name__)

__all__ = ["save_snapshot", "load_loader_state", "LOADER_STATE_FILE"]

INFOS_PATTERN = r"z_info_e[0-9]*?_i[0-9]*?-[0-9]*?.json"

# Sidecar with the epoch sampler's stream position (EpochSampler.state_dict)
# — ADDITIVE next to the reference-format z_info, so the z_info schema and
# key set stay bit-compatible with the reference. The reference does not
# checkpoint dataloader position at all (its loaders restart at 0 on
# resume, src/captioning/dataloader.py:238-240); with this sidecar a resume
# continues the exact batch stream.
LOADER_STATE_FILE = "z_loader_state.json"


def save_snapshot(stats, it, experiment, loader_state: dict | None = None) -> str:
    directory = mkdir_p(experiment.snapshot_dir())
    remove_file_with_pattern(INFOS_PATTERN, directory)
    filename = "z_info_e{e}_i{i}-{n}.json".format(
        e=it.epoch(), i=it.iteration(), n=experiment.orig_trainloader_lth()
    )
    infos = {**stats.to_dict(), **it.to_dict(), **experiment.to_dict()}
    path = os.path.join(directory, filename)
    assert not os.path.exists(path)
    with open(path, "w") as f:
        json.dump(infos, f)
    side = os.path.join(directory, LOADER_STATE_FILE)
    if loader_state is not None:
        # atomic write, stamped with the z_info it belongs to: a crash
        # between the two writes must not leave a previous-iteration sidecar
        # silently rewinding a later resume's batch stream
        payload = {**loader_state, "z_info": filename}
        tmp = side + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, side)
    elif os.path.exists(side):
        # no live sampler at this snapshot: a stale sidecar would rewind a
        # later resume to an older stream position
        os.remove(side)
    logger.info("Saved snapshot %s", filename)
    return path


def load_loader_state(infos_path: str) -> dict | None:
    """The loader-state sidecar next to a z_info file (from_infos resume),
    or None when absent (reference-made or pre-sidecar checkpoints) or when
    it is stamped for a DIFFERENT z_info (crash between the two snapshot
    writes) — resuming with a mismatched sidecar would silently rewind the
    batch stream to an older position."""
    side = os.path.join(os.path.dirname(infos_path), LOADER_STATE_FILE)
    if not os.path.exists(side):
        return None
    with open(side) as f:
        state = json.load(f)
    stamp = state.pop("z_info", None)
    if stamp is not None and stamp != os.path.basename(infos_path):
        logger.warning(
            "loader-state sidecar is stamped for %s but resuming %s — "
            "ignoring it (fresh epoch stream)",
            stamp, os.path.basename(infos_path))
        return None
    return state

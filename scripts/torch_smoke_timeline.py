"""Where chip_smoke.py's wall time goes: the smoke run in this process under
a wall-clock stack sampler.

A thread samples the main thread's Python stack every ``--every`` seconds
(waits on the card, on child processes and on files included) and counts,
per function, the samples it is on the stack (inclusive) and, per line,
the samples it is the innermost frame (self); each stdout line of the smoke
is copied to ``OUT/timeline.log`` with the seconds since the start. At the
end ``OUT/samples.json`` holds the counts ({"every", "incl", "self",
"stacks"}: seconds are counts times ``every``). The smoke's own output and
exit code are unchanged. Child processes (ranks, entry points, builds) are
seen only as the main thread's wait for them.

Usage, on the card through the chip tool, from the repository's root:
    chiprun --timeout 1800 -- python3 scripts/torch_smoke_timeline.py \\
        --out chiprun_out/timeline
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import runpy
import sys
import threading
import time


class _Stamped:
    """stdout that also writes each line, with its seconds, to a file."""

    def __init__(self, out, path: str, t0: float):
        self._out, self._t0, self._buf = out, t0, ""
        self._log = open(path, "w")

    def write(self, text: str) -> int:
        self._out.write(text)
        self._buf += text
        *lines, self._buf = self._buf.split("\n")
        for line in lines:
            self._log.write(f"{time.time() - self._t0:8.1f} {line}\n")
        self._log.flush()
        return len(text)

    def flush(self) -> None:
        self._out.flush()

    def __getattr__(self, name):
        return getattr(self._out, name)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/timeline")
    ap.add_argument("--every", type=float, default=0.25)
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    smoke = os.path.join(root, "chip_smoke.py")
    sys.path.insert(0, root)

    main_id = threading.get_ident()
    incl, self_, stacks = (collections.Counter() for _ in range(3))
    done = threading.Event()

    def sample():
        while not done.wait(args.every):
            frame = sys._current_frames().get(main_id)
            if frame is None:
                continue
            code = frame.f_code
            self_[f"{os.path.basename(code.co_filename)}:{code.co_name}:"
                  f"{frame.f_lineno}"] += 1
            seen, chain = set(), []
            while frame is not None:
                code = frame.f_code
                key = f"{os.path.basename(code.co_filename)}:{code.co_name}"
                chain.append(f"{key}:{frame.f_lineno}")
                if key not in seen:
                    incl[key] += 1
                    seen.add(key)
                frame = frame.f_back
            # the innermost three frames of the smoke, and the innermost
            own = [c for c in reversed(chain) if c.startswith("chip_smoke")]
            stacks[" > ".join(own[-3:]) + " || " + chain[0]] += 1
            del frame, chain

    sys.stdout = _Stamped(sys.stdout, os.path.join(args.out, "timeline.log"),
                          time.time())
    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    sys.argv = [smoke]
    rc = 0
    try:
        runpy.run_path(smoke, run_name="__main__")
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else (e.code is not None)
    finally:
        done.set()
        thread.join()
        sys.stdout.flush()
        with open(os.path.join(args.out, "samples.json"), "w") as f:
            json.dump({"every": args.every,
                       "incl": incl.most_common(300),
                       "self": self_.most_common(300),
                       "stacks": stacks.most_common(400)}, f, indent=0)
    return rc


if __name__ == "__main__":
    sys.exit(main())

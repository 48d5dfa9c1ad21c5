"""Where the time of a whole `chip_smoke.py` run goes, on the GPU.

Runs chip_smoke.main() with a stack sampler: a thread that reads the main
thread's stack every --period seconds and counts each chip_smoke.py
function and line on it (once per sample, so the counts are inclusive).
Writes the seconds per function and per line, largest first, as JSON to
--out; the smoke's own output goes to stdout as usual. The sampler reads
the main thread only: a check's CPU side on a thread of its own
(chip_smoke.Background) shows as the main thread's wait for it.

    python3 smoke_profile.py --out chiprun_out/smoke_samples.json
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import threading


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/smoke_samples.json")
    ap.add_argument("--period", type=float, default=0.1)
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke

    main_id = threading.get_ident()
    lines, funcs = collections.Counter(), collections.Counter()
    stop = threading.Event()

    def sample():
        while not stop.wait(args.period):
            frame = sys._current_frames().get(main_id)
            seen = set()
            while frame is not None:
                code = frame.f_code
                if code.co_filename.endswith("chip_smoke.py"):
                    for key, counter in ((code.co_name, funcs), (
                            f"{code.co_name}:{frame.f_lineno}", lines)):
                        if (counter is funcs, key) not in seen:
                            seen.add((counter is funcs, key))
                            counter[key] += 1
                frame = frame.f_back

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    try:
        chip_smoke.main()
    finally:
        stop.set()
        sampler.join()
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"period_s": args.period,
                       "funcs_s": {k: v * args.period
                                   for k, v in funcs.most_common()},
                       "lines_s": {k: v * args.period
                                   for k, v in lines.most_common()}},
                      fh, indent=0)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run a command and clock its output by phase tag.

    python3 tools/phase_clock.py --log build/run.log -- \
        python3 chip_smoke.py

Every line the command prints is passed on and also written to ``--log``
prefixed with the seconds since the command started (the child runs with
``PYTHONUNBUFFERED=1``, so a line's time is when it was printed). At the
end one ``[clock]`` line sums, per leading ``[tag]``, the seconds from the
previous tagged line to each of the tag's lines: a phase that prints its
lines as it goes is charged its own time, and a line of another tag
printed inside a phase (``[decode]`` in ``[lm]``) takes its share. This
reads the time of a script that prints no seconds of its own, such as a
parent tree's ``chip_smoke.py`` from before its ``[phases]`` line, and
splits a phase by the tags printed inside it (``[profile]``, ``[time]``
and ``[decode]`` lines, which ``[phases]`` charges to their phase). The
exit code is the command's.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import time

TAG = re.compile(r"^\[([^\]]+)\]")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log", required=True, help="file for the timed lines")
    ap.add_argument("cmd", nargs=argparse.REMAINDER)
    args = ap.parse_args()
    cmd = args.cmd[1:] if args.cmd[:1] == ["--"] else args.cmd
    if not cmd:
        ap.error("no command given")
    os.makedirs(os.path.dirname(os.path.abspath(args.log)), exist_ok=True)
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    t0 = time.perf_counter()
    last, per_tag, order = 0.0, {}, []
    with open(args.log, "w") as out:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, env=env,
                                text=True, bufsize=1)
        for line in proc.stdout:
            now = time.perf_counter() - t0
            sys.stdout.write(line)
            out.write(f"{now:9.2f} {line}")
            m = TAG.match(line)
            if m:
                tag = m.group(1).split()[0]
                if tag not in per_tag:
                    order.append(tag)
                per_tag[tag] = per_tag.get(tag, 0.0) + now - last
                last = now
        rc = proc.wait()
        total = time.perf_counter() - t0
        summary = {"total_s": round(total, 2), "rc": rc,
                   "by_tag_s": {k: round(per_tag[k], 2) for k in order}}
        out.write(f"[clock] {json.dumps(summary)}\n")
    print(f"[clock] {json.dumps(summary)}", file=sys.stderr, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())

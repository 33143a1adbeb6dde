"""Run chaos scenarios through the package's ``chaos`` command, each as
often as asked and each run in a fresh work directory, and print one
JSON line a run: exit code, wall seconds, the invariants held, the ones
that failed, and the kernel launches the scenario counted in its process
and its rank processes.

    python -m pytorch_distributed_nn_tpu_torch.tools.chaos_check \\
        --device cuda --repeat 10 --out runs.json \\
        "live_reload --cases canary" "replica_loss --cases kill"

Each positional argument is one scenario with its flags, as ``chaos``
takes them after ``--scenario``. On the card the first line printed is
``nvidia-smi``'s name and power limit, and each row carries it. A
``live_reload`` row also carries the serving latency of each version its
stream records (count, p50, p99, max in ms) and the deployment events in
order, so a conviction can be read against the gate's inputs. ``--out``
writes every row as one JSON list. Exit code: 0 when every run exited 0,
else 1.
"""

import argparse
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

_CHECK = re.compile(r"^  \[(PASS|FAIL)\] (.+)$")
_LAUNCHES = re.compile(r"^chaos \S+: kernel launches (\{.*\}) ")


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"


def _latency(workdir: str) -> dict:
    """Per serve stream under ``workdir``: each version's latency
    summary, and the canary/promote/rollback events in order."""
    from pytorch_distributed_nn_tpu_torch.observability import reader

    out = {}
    for d in sorted(glob.glob(os.path.join(workdir, "**", "serve"),
                              recursive=True)):
        rs = reader.read_stream(d)
        by = {}
        for rec in rs.steps:
            if rec.get("latency_ms") is not None:
                by.setdefault(str(rec.get("version")), []).append(
                    rec["latency_ms"])
        stats = {}
        for version, lat in by.items():
            lat.sort()

            def pc(q, lat=lat):
                return lat[min(len(lat) - 1, int(q * len(lat)))]

            stats[version] = {"n": len(lat), "p50": pc(0.5),
                              "p99": pc(0.99), "max": lat[-1]}
        events = [[e.get("type"), e.get("reasons") or e.get("phase")]
                  for e in rs.events
                  if e.get("type") in ("canary", "promote", "rollback")]
        out[os.path.relpath(d, workdir)] = {"latency": stats,
                                            "events": events}
    return out


def run_once(spec: str, device: str, root: str, card: str,
             timeout: float) -> dict:
    """One ``chaos --scenario SPEC --device DEVICE`` run in a fresh
    directory under ``root``, as a row."""
    argv = spec.split()
    workdir = tempfile.mkdtemp(prefix="run-", dir=root)
    t0 = time.perf_counter()
    try:
        r = subprocess.run(
            [sys.executable, "-m", "pytorch_distributed_nn_tpu_torch",
             "chaos", "--scenario", *argv, "--device", device,
             "--workdir", workdir, "--keep"],
            capture_output=True, text=True, timeout=timeout)
        rc, out, err = r.returncode, r.stdout, r.stderr
    except subprocess.TimeoutExpired as e:
        rc, out, err = "timeout", e.stdout or "", e.stderr or ""
        out = out if isinstance(out, str) else out.decode()
        err = err if isinstance(err, str) else err.decode()
    seconds = time.perf_counter() - t0
    held, failed, launches = [], [], None
    for line in out.splitlines():
        m = _CHECK.match(line)
        if m:
            (held if m.group(1) == "PASS" else failed).append(m.group(2))
        m = _LAUNCHES.match(line)
        if m:
            launches = json.loads(m.group(1))
    row = {"scenario": spec, "device": device, "rc": rc,
           "seconds": round(seconds, 3), "held": len(held),
           "checks": len(held) + len(failed), "failed": failed,
           "launches": launches, "card": card}
    if argv[0] == "live_reload":
        row["serve"] = _latency(workdir)
    if rc != 0 and not failed:
        row["error_tail"] = (out[-1500:] + "\n" + err[-3000:]).strip()
    shutil.rmtree(workdir, ignore_errors=True)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("scenarios", nargs="+",
                    help='a scenario and its flags, e.g. "live_reload '
                         '--cases canary"')
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--timeout", type=float, default=1200.0,
                    help="seconds a run may take before it is cut")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    card = _card() if args.device.startswith("cuda") else "cpu"
    print(card, flush=True)
    rows = []
    root = tempfile.mkdtemp(prefix="pdtn_chaos_check_")
    try:
        for spec in args.scenarios:
            for i in range(args.repeat):
                row = dict(run_once(spec, args.device, root, card,
                                    args.timeout), run=i + 1)
                rows.append(row)
                print(json.dumps(row), flush=True)
                if args.out:
                    with open(args.out, "w") as f:
                        json.dump(rows, f, indent=1)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0 if all(r["rc"] == 0 for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())

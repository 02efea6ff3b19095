"""Summarize a distillation run prefix into sustained-throughput numbers
(counterpart of ``tools/run_report.py``).

    python -m tha4_tpu_torch.tools.run_report PREFIX [--batch 8] [--json] [--phases]

Reads ``PREFIX/{face,body}_morpher/log/scalars.jsonl``, which the trainer
writes (``training/trainer.py``: a row of the named losses with
``examples_seen``, ``lr`` and ``elapsed`` every ``log_every_seconds``), and
reports per student:

  * the wall-clock span the log covers (resume-aware: ``elapsed`` restarts
    with a resumed run, so the log is split wherever it decreases);
  * sustained examples/s and ms/step with all host work included
    (checkpoint and snapshot writes, sample grids, logging): the number
    that decides a character's distillation time, where
    ``tools/profile_step.py`` times the step alone;
  * the first and last loss.

``--phases``: the body student per phase of the production six-phase
schedule (``recipes.default_body_phases``): sustained ms/step, the loss at
entry and exit, and the lrs the log shows inside each phase.
"""

from __future__ import annotations

import argparse
import json
import os


def read_segments(path):
    """[[row, ...], ...]: the log split wherever ``elapsed`` decreases;
    segments of fewer than two rows are dropped."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    segments = []
    start = 0
    for i in range(1, len(rows)):
        if rows[i]["elapsed"] < rows[i - 1]["elapsed"]:
            segments.append(rows[start:i])
            start = i
    segments.append(rows[start:])
    return [s for s in segments if len(s) >= 2]


def report_student(name, prefix, batch):
    path = os.path.join(prefix, f"{name}_morpher", "log", "scalars.jsonl")
    if not os.path.isfile(path):
        return None
    segments = read_segments(path)
    if not segments:
        return None
    examples = 0.0
    seconds = 0.0
    for seg in segments:
        examples += seg[-1]["examples_seen"] - seg[0]["examples_seen"]
        seconds += seg[-1]["elapsed"] - seg[0]["elapsed"]
    if examples <= 0 or seconds <= 0:
        return None
    eps = examples / seconds
    return {
        "student": name,
        "segments": len(segments),
        "examples_covered": int(examples),
        "examples_seen": int(segments[-1][-1]["examples_seen"]),
        "wall_s": round(seconds, 1),
        "examples_per_s": round(eps, 1),
        "ms_per_step": round(1000.0 * batch / eps, 2),
        "first_loss": segments[0][0].get("loss"),
        "last_loss": segments[-1][-1].get("loss"),
    }


def report_phases(name, prefix, batch, boundaries):
    """Per phase between ``boundaries`` (cumulative examples): sustained
    ms/step, the loss at entry and exit, and the lrs observed inside it."""
    path = os.path.join(prefix, f"{name}_morpher", "log", "scalars.jsonl")
    if not os.path.isfile(path):
        return []
    segments = read_segments(path)
    spans = list(zip([0] + boundaries[:-1], boundaries))
    acc = [{"examples": 0.0, "seconds": 0.0, "losses": [], "lrs": set()} for _ in spans]

    def phase_of(examples):
        for i, (lo, hi) in enumerate(spans):
            if lo <= examples < hi:
                return i
        return len(spans) - 1

    for seg in segments:
        for a, b in zip(seg, seg[1:]):
            p = phase_of(0.5 * (a["examples_seen"] + b["examples_seen"]))
            acc[p]["examples"] += b["examples_seen"] - a["examples_seen"]
            acc[p]["seconds"] += b["elapsed"] - a["elapsed"]
        for row in seg:
            p = phase_of(row["examples_seen"])
            acc[p]["losses"].append((row["examples_seen"], row["loss"]))
            if "lr" in row:
                acc[p]["lrs"].add(row["lr"])

    out = []
    for i, ((lo, hi), a) in enumerate(zip(spans, acc)):
        if a["examples"] <= 0 or a["seconds"] <= 0:
            continue
        losses = sorted(a["losses"])
        out.append(
            {
                "phase": i + 1,
                "span": [lo, hi],
                "examples_covered": int(a["examples"]),
                "ms_per_step": round(1000.0 * batch * a["seconds"] / a["examples"], 2),
                "entry_loss": losses[0][1],
                "exit_loss": losses[-1][1],
                "lrs_observed": sorted(a["lrs"]),
            }
        )
    return out


def main(argv=None):
    """Prints the report; returns its rows (the ``--json`` list)."""
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("prefix")
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--json", action="store_true")
    parser.add_argument("--phases", action="store_true",
                        help="per-phase rollup for the body student against the production six-phase schedule "
                        "(recipes.default_body_phases)")
    args = parser.parse_args(argv)

    if args.phases:
        from tha4_tpu_torch.distiller import recipes

        boundaries = [p.num_examples_upper_bound for p in recipes.default_body_phases().phases]
        rows = report_phases("body", args.prefix, args.batch, boundaries)
        if args.json:
            print(json.dumps(rows))
            return rows
        for r in rows:
            lrs = "/".join(f"{x:g}" for x in r["lrs_observed"])
            print(
                f"phase {r['phase']} [{r['span'][0]:>9,}-{r['span'][1]:>9,})  "
                f"{r['ms_per_step']:6.2f} ms/step over {r['examples_covered']:>9,} ex  "
                f"loss {r['entry_loss']:.4f} -> {r['exit_loss']:.4f}  lr {lrs}"
            )
        if not rows:
            print(f"no body scalars found under {args.prefix}")
        return rows

    out = []
    for name in ("face", "body"):
        r = report_student(name, args.prefix, args.batch)
        if r:
            out.append(r)
    if args.json:
        print(json.dumps(out))
        return out
    for r in out:
        print(
            f"{r['student']:5s} examples {r['examples_seen']:>9,}  "
            f"sustained {r['examples_per_s']:>7.1f} ex/s = {r['ms_per_step']:6.2f} ms/step "
            f"(B{args.batch}, host work included)  "
            f"loss {r['first_loss']:.4f} -> {r['last_loss']:.4f}  "
            f"[{r['wall_s']/3600:.2f} h logged, {r['segments']} segment(s)]"
        )
    if not out:
        print(f"no scalars found under {args.prefix}")
    return out


if __name__ == "__main__":
    main()

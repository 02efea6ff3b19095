"""Compare two puppeteer settings in alternating pairs on one card.

    python -m tha4_tpu_torch.tools.puppeteer_pairs [--model character_model.yaml] [--pairs 10] \\
        --a="--dtype bf16" --b="--dtype f32" -- --source file:tests/fixtures/ifacialmocap_trace.jsonl --realtime

Runs ``apps.puppeteer.main`` in this process ``2 * --pairs`` times with the
arguments after ``--`` plus ``--a`` or ``--b`` (each split as a shell would)
and ``--benchmark`` (write ``--a=...``: a value that starts with ``--``
needs the ``=``), in the order a b, b a, a b, ... so that a drift of the
host or the card's clocks falls on both sides alike.  Without ``--model``
the character is the full-width random-init model of
``charmodel.synthetic.write_random_character_model`` (seed 0), written to a
temporary directory.  Prints one JSON line a run (the puppeteer's benchmark
line parsed: throughput, latency mean / p50 / p99, frames rendered), then one
summary line: each side's medians and the number of pairs in which ``a`` had
the higher throughput and the lower p50 latency, beside the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import shlex
import statistics
import sys
import tempfile

LINE = re.compile(r"frames=(\d+) rendered=(\d+) latency mean=([\d.]+)ms p50=([\d.]+)ms p99=([\d.]+)ms "
                  r"throughput=([\d.]+) fps")
KEYS = ("frames", "rendered", "latency_mean_ms", "latency_p50_ms", "latency_p99_ms", "fps")


def parse(stdout: str) -> dict:
    """The puppeteer's ``--benchmark`` line as numbers."""
    for line in stdout.splitlines():
        match = LINE.match(line)
        if match:
            return {k: (int(v) if k in ("frames", "rendered") else float(v)) for k, v in zip(KEYS, match.groups())}
    raise ValueError(f"no benchmark line in the puppeteer's output:\n{stdout}")


def run(argv: list) -> dict:
    """One ``puppeteer.main(argv + ['--benchmark'])``; its parsed line."""
    from tha4_tpu_torch.apps import puppeteer

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = puppeteer.main([*argv, "--benchmark"])
    if rc != 0:
        raise SystemExit(f"puppeteer {argv}: rc {rc}\n{out.getvalue()}")
    return parse(out.getvalue())


def summary(runs: list) -> dict:
    """Medians by side and the pairs ``a`` won, from ``[(side, result), ...]``
    in the order they ran (each pair is two consecutive runs)."""
    sides = {s: [r for side, r in runs if side == s] for s in ("a", "b")}
    out = {s: {k: statistics.median(r[k] for r in rs) for k in ("fps", "latency_p50_ms", "latency_p99_ms")}
           for s, rs in sides.items()}
    pairs = list(zip(sides["a"], sides["b"]))
    out["pairs"] = len(pairs)
    out["a_higher_fps"] = sum(a["fps"] > b["fps"] for a, b in pairs)
    out["a_lower_p50"] = sum(a["latency_p50_ms"] < b["latency_p50_ms"] for a, b in pairs)
    return out


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    common = argv[argv.index("--") + 1:] if "--" in argv else []
    own = argv[: argv.index("--")] if "--" in argv else argv
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--model", default=None, help="character_model.yaml (default: a full-width random-init model)")
    parser.add_argument("--pairs", type=int, default=10)
    parser.add_argument("--a", default="", help="the puppeteer arguments of side a")
    parser.add_argument("--b", default="", help="the puppeteer arguments of side b")
    args = parser.parse_args(own)

    from tha4_tpu_torch.charmodel.synthetic import write_random_character_model
    from tha4_tpu_torch.tools.bench import card

    import torch

    with tempfile.TemporaryDirectory(prefix="tha4_pairs_") as tmp:
        model = args.model or write_random_character_model(tmp, seed=0)
        sides = {"a": shlex.split(args.a), "b": shlex.split(args.b)}
        runs = []
        for i in range(args.pairs):
            for side in ("a", "b") if i % 2 == 0 else ("b", "a"):
                result = run(["--model", model, *common, *sides[side]])
                runs.append((side, result))
                print(json.dumps({"pair": i, "side": side, "args": args.a if side == "a" else args.b, **result}),
                      flush=True)
    device = next((common[i + 1] for i, a in enumerate(common[:-1]) if a == "--device"), "cuda")
    description = card(torch.device(device)) if torch.device(device).type == "cuda" else device
    print(json.dumps({"a": args.a, "b": args.b, "common": shlex.join(common), **summary(runs), "card": description}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

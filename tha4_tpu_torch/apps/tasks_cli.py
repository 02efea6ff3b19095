"""tha4-torch-tasks — list, browse, and run distillation tasks from the command
line (counterpart of ``tha4_tpu/apps/tasks_cli.py``; for one config it
lists the same tasks in the same text).

Equivalent of the reference's TaskSelectorUi (a wx tree of the task DAG where
selecting a task runs it, reference: src/tha4/pytasuku/task_selector_ui.py:1-113):
enumerate the task DAG of a distillation config, show what is up to date, and
run any task by name — flat (``--list``), as the selector's path tree
(``--tree``), or interactively (``--interactive``: the tree with numbered
tasks; type a number or a task name to run it, like double-clicking a node).

A task runs on the card unless ``--device cpu`` is given.

Examples:
  tha4-torch-tasks --config_file jobs/mychar/config.yaml --list
  tha4-torch-tasks --config_file jobs/mychar/config.yaml --tree
  tha4-torch-tasks --config_file jobs/mychar/config.yaml --interactive
  tha4-torch-tasks --config_file jobs/mychar/config.yaml --run jobs/mychar/all
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional, Tuple


def _status(task) -> str:
    from tha4_tpu_torch.tasks.workspace import CommandTask, FileTask

    if isinstance(task, FileTask):
        return "STALE" if task.needs_to_run() else "up to date"
    if isinstance(task, CommandTask):
        return "command"
    return "file"


def _build_tree(names: List[str]) -> Dict:
    """Nested dict keyed by path segment; the reference selector shows the
    same segmentation as wx tree nodes (task_selector_ui.py builds node per
    '/'-component)."""
    root: Dict = {}
    for name in sorted(names):
        node = root
        for part in name.split("/"):
            node = node.setdefault(part, {})
        node["\0task"] = name
    return root


def _render_tree(workspace, numbered: bool) -> Tuple[List[str], List[str]]:
    """Returns (lines, ordered task names). Tasks get ``[n]`` prefixes when
    ``numbered`` so the interactive mode can select by index."""
    lines: List[str] = []
    order: List[str] = []

    def walk(node: Dict, depth: int) -> None:
        for key in sorted(k for k in node if key_visible(k)):
            child = node[key]
            full = child.get("\0task")
            indent = "  " * depth
            if full is not None:
                task = workspace.tasks.get(full)
                status = _status(task) if task is not None else "?"
                order.append(full)
                tag = f"[{len(order)}] " if numbered else ""
                lines.append(f"{indent}{tag}{key}  ({status})")
            else:
                lines.append(f"{indent}{key}/")
            walk({k: v for k, v in child.items() if k != "\0task"}, depth + 1)

    def key_visible(k: str) -> bool:
        return k != "\0task"

    walk(_build_tree(list(workspace.tasks)), 0)
    return lines, order


def _interactive_loop(workspace) -> int:
    """The TaskSelectorUi loop: show the tree, select a task, run it, refresh
    (the reference re-enables its tree after each run; we re-render so the
    STALE/up-to-date markers update)."""
    while True:
        lines, order = _render_tree(workspace, numbered=True)
        print()
        print("\n".join(lines))
        print()
        try:
            choice = input("task # or name (q to quit): ").strip()
        except EOFError:
            return 0
        if choice in ("q", "quit", "exit", ""):
            return 0
        name: Optional[str] = None
        if choice.isdigit() and 1 <= int(choice) <= len(order):
            name = order[int(choice) - 1]
        elif choice in workspace.tasks:
            name = choice
        if name is None:
            print(f"no such task: {choice!r}")
            continue
        try:
            workspace.run(name)
            print(f"done: {name}")
        except KeyboardInterrupt:
            print(f"\ninterrupted: {name} (rerun resumes from the newest snapshot)")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config_file", required=True)
    parser.add_argument("--list", action="store_true", help="list tasks and their status (flat)")
    parser.add_argument("--tree", action="store_true", help="show the task DAG as the selector's path tree")
    parser.add_argument(
        "--interactive",
        action="store_true",
        help="interactive selector: the numbered tree; type a number or name to run it",
    )
    parser.add_argument("--run", default=None, metavar="TASK", help="run one task (and its dependencies)")
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu (the kernels' plain versions)")
    args = parser.parse_args(argv)

    from tha4_tpu_torch.distiller.config import DistillerConfig
    from tha4_tpu_torch.distiller.pipeline import DistillationJobs
    from tha4_tpu_torch.tasks.workspace import Workspace

    config = DistillerConfig.load(args.config_file)
    jobs = DistillationJobs(config, device=args.device)
    workspace = Workspace()
    jobs.define_tasks(workspace)

    if args.run:
        workspace.run(args.run)
        return 0
    if args.interactive:
        return _interactive_loop(workspace)
    if args.tree:
        lines, _ = _render_tree(workspace, numbered=False)
        print("\n".join(lines))
        return 0

    # default: list
    for name in sorted(workspace.tasks):
        print(f"{_status(workspace.tasks[name]):>10}  {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

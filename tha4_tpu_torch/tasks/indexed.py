"""Indexed task families (counterpart of ``tha4_tpu/tasks/indexed.py``;
reference: src/tha4/pytasuku/indexed/).

Families of file tasks parameterized by one or two integer indices — e.g.
"render frame %03d" — plus an umbrella command task that depends on every
member.  The reference ships these as generic machinery (unused by the
distill path); kept for capability parity.
"""

from __future__ import annotations

from typing import Callable, List

from tha4_tpu_torch.tasks.workspace import Workspace


def define_indexed_file_tasks(
    workspace: Workspace,
    name_func: Callable[[int], str],
    dependencies_func: Callable[[int], List[str]],
    run_func: Callable[[int], None],
    count: int,
    umbrella_name: str,
) -> List[str]:
    """One FileTask per index + an umbrella command task depending on all."""
    names = []
    for index in range(count):
        name = name_func(index)

        def run(index=index):
            run_func(index)

        workspace.create_file_task(name, dependencies_func(index), run)
        names.append(name)
    workspace.create_command_task(umbrella_name, list(names))
    return names


def define_doubly_indexed_file_tasks(
    workspace: Workspace,
    name_func: Callable[[int, int], str],
    dependencies_func: Callable[[int, int], List[str]],
    run_func: Callable[[int, int], None],
    count0: int,
    count1: int,
    umbrella_name: str,
) -> List[str]:
    names = []
    for i in range(count0):
        for j in range(count1):
            name = name_func(i, j)

            def run(i=i, j=j):
                run_func(i, j)

            workspace.create_file_task(name, dependencies_func(i, j), run)
            names.append(name)
    workspace.create_command_task(umbrella_name, list(names))
    return names

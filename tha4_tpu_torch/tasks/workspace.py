"""Make-like file-task DAG runner (pytasuku equivalent; a copy of
``tha4_tpu/tasks/workspace.py``, which the port does not import).

Reference: src/tha4/pytasuku/{task.py,workspace.py}.  Semantics preserved
because interruptibility is a documented product feature (docs/distill.md:
Ctrl-C any time, rerun the same command):

  * FileTask reruns iff its file is missing, any dependency needs running, or
    any dependency file is newer (task.py:82-100);
  * PlaceholderTask represents a plain existing file (:50-70);
  * CommandTask always runs after its dependencies (:41-47);
  * Workspace does a DFS cycle check on task creation (workspace.py:104-120)
    and memoizes done-ness within a session (:129-146).

Under data parallelism every rank runs the same DAG: rank 0 decides whether
each task needs to run and broadcasts its decision (``parallel.mesh.agree``),
so that every rank enters the same training tasks, whose steps are
collectives.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional

from tha4_tpu_torch.parallel import mesh


class Task:
    def __init__(self, workspace: "Workspace", name: str, dependencies: List[str]):
        self.workspace = workspace
        self.name = name
        self.dependencies = dependencies

    def run(self) -> None:
        pass

    def needs_to_run(self) -> bool:
        return True

    def timestamp(self) -> float:
        return 0.0


class PlaceholderTask(Task):
    """A plain file dependency: never runs, must exist when depended upon."""

    def needs_to_run(self) -> bool:
        return False

    def timestamp(self) -> float:
        if not os.path.exists(self.name):
            raise RuntimeError(f"Dependency file {self.name} does not exist")
        return os.path.getmtime(self.name)


class CommandTask(Task):
    def __init__(self, workspace, name, dependencies, func: Optional[Callable[[], None]] = None):
        super().__init__(workspace, name, dependencies)
        self.func = func

    def run(self) -> None:
        if self.func is not None:
            self.func()


class FileTask(Task):
    def __init__(self, workspace, name, dependencies, func: Callable[[], None]):
        super().__init__(workspace, name, dependencies)
        self.func = func

    def run(self) -> None:
        self.func()

    def timestamp(self) -> float:
        if not os.path.exists(self.name):
            return float("inf")
        return os.path.getmtime(self.name)

    def needs_to_run(self) -> bool:
        if not os.path.exists(self.name):
            return True
        my_time = self.timestamp()
        for dep in self.dependencies:
            task = self.workspace.get_task(dep)
            if task.needs_to_run():
                return True
            if task.timestamp() > my_time:
                return True
        return False


class Workspace:
    def __init__(self):
        self.tasks: Dict[str, Task] = {}
        self._session_done: set = set()

    def get_task(self, name: str) -> Task:
        if name not in self.tasks:
            if os.path.exists(name):
                self.tasks[name] = PlaceholderTask(self, name, [])
            else:
                raise KeyError(f"No task or file named {name}")
        return self.tasks[name]

    def _register(self, task: Task) -> None:
        if task.name in self.tasks:
            raise ValueError(f"Task {task.name} already defined")
        self.tasks[task.name] = task
        self._check_cycles(task.name, set())

    def _check_cycles(self, name: str, seen: set) -> None:
        if name in seen:
            raise ValueError(f"Dependency cycle through {name}")
        task = self.tasks.get(name)
        if task is None:
            return
        seen = seen | {name}
        for dep in task.dependencies:
            self._check_cycles(dep, seen)

    def create_file_task(self, name: str, dependencies: List[str], func: Callable[[], None]) -> FileTask:
        task = FileTask(self, name, dependencies, func)
        self._register(task)
        return task

    def create_command_task(
        self, name: str, dependencies: List[str], func: Optional[Callable[[], None]] = None
    ) -> CommandTask:
        task = CommandTask(self, name, dependencies, func)
        self._register(task)
        return task

    def run(self, name: str) -> None:
        if name in self._session_done:
            return
        task = self.get_task(name)
        for dep in task.dependencies:
            self.run(dep)
        if mesh.agree(task.needs_to_run()):
            task.run()
        self._session_done.add(name)

    def start_session(self) -> None:
        self._session_done = set()


def file_task(workspace: Workspace, name: str, dependencies: List[str]):
    """Decorator form (reference workspace.py:155-160)."""

    def wrap(func):
        workspace.create_file_task(name, dependencies, func)
        return func

    return wrap


def command_task(workspace: Workspace, name: str, dependencies: List[str]):
    def wrap(func):
        workspace.create_command_task(name, dependencies, func)
        return func

    return wrap

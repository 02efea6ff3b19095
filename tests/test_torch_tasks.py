"""The port's file-task DAG (``tha4_tpu_torch/tasks/workspace.py``) and
``tha4-torch-tasks`` against the JAX package's.

The same DAG of temporary files, built in both packages' ``Workspace``, runs
the same tasks in the same order, is equally stale after a dependency is
touched, and raises on the same cycle; the two ``tasks`` CLIs print the same
text for the same distillation config.
"""

import os

import pytest

from tha4_tpu.apps import tasks_cli as jtasks_cli
from tha4_tpu.tasks import workspace as jworkspace
from tha4_tpu_torch.apps import tasks_cli
from tha4_tpu_torch.charmodel.synthetic import write_distiller_inputs
from tha4_tpu_torch.tasks import workspace

PACKAGES = {"jax": jworkspace, "port": workspace}


def _dag(ws_module, root: str, log: list):
    """source.txt (a plain file) -> a.txt -> b.txt, a.txt -> c.txt, and a
    command task 'all' over b and c.  Each file task appends its name to
    ``log`` and writes its file."""
    ws = ws_module.Workspace()
    path = lambda name: os.path.join(root, name)  # noqa: E731

    def writer(name):
        def run():
            log.append(name)
            with open(path(name), "w") as f:
                f.write(name)

        return run

    ws.create_file_task(path("a.txt"), [path("source.txt")], writer("a.txt"))
    ws.create_file_task(path("b.txt"), [path("a.txt")], writer("b.txt"))

    @ws_module.file_task(ws, path("c.txt"), [path("a.txt")])
    def make_c():
        writer("c.txt")()

    ws.create_command_task(path("all"), [path("b.txt"), path("c.txt")], lambda: log.append("all"))
    return ws


@pytest.fixture
def roots(tmp_path):
    out = {}
    for name in PACKAGES:
        root = tmp_path / name
        root.mkdir()
        (root / "source.txt").write_text("source")
        out[name] = str(root)
    return out


def _staleness(ws, root):
    return {name: ws.get_task(os.path.join(root, name)).needs_to_run() for name in ("a.txt", "b.txt", "c.txt", "all")}


def test_same_tasks_run_in_the_same_order(roots):
    logs = {}
    for name, module in PACKAGES.items():
        log = []
        _dag(module, roots[name], log).run(os.path.join(roots[name], "all"))
        logs[name] = log
    assert logs["port"] == logs["jax"] == ["a.txt", "b.txt", "c.txt", "all"]
    # A fresh session over up-to-date files runs the command task alone.
    for name, module in PACKAGES.items():
        log = []
        ws = _dag(module, roots[name], log)
        assert _staleness(ws, roots[name]) == {"a.txt": False, "b.txt": False, "c.txt": False, "all": True}
        ws.run(os.path.join(roots[name], "all"))
        ws.run(os.path.join(roots[name], "all"))  # done-ness is memoized within the session
        assert log == ["all"]


@pytest.mark.parametrize("touched,missing", [("source.txt", None), ("a.txt", None), (None, "b.txt"), (None, "a.txt")])
def test_equally_stale_after_a_dependency_changes(roots, touched, missing):
    """A dependency made newer than its dependants, or a file removed:
    both packages mark the same tasks stale and rerun the same ones."""
    runs = {}
    for name, module in PACKAGES.items():
        root = roots[name]
        _dag(module, root, []).run(os.path.join(root, "all"))
        later = max(os.path.getmtime(os.path.join(root, f)) for f in ("a.txt", "b.txt", "c.txt")) + 10.0
        if touched is not None:
            os.utime(os.path.join(root, touched), (later, later))
        if missing is not None:
            os.remove(os.path.join(root, missing))
        log = []
        ws = _dag(module, root, log)
        stale = _staleness(ws, root)
        ws.run(os.path.join(root, "all"))
        runs[name] = (stale, log)
    assert runs["port"] == runs["jax"]
    assert runs["port"][1][-1] == "all" and len(runs["port"][1]) >= 2


def test_files_written_in_the_same_instant_are_up_to_date(roots):
    """On a coarse filesystem a task's file and its dependency's share a
    timestamp: a dependency no newer than its dependant leaves it up to
    date in both packages, so a rerun runs only the command task."""
    for name, module in PACKAGES.items():
        root = roots[name]
        _dag(module, root, []).run(os.path.join(root, "all"))
        stamp = float(int(os.path.getmtime(os.path.join(root, "a.txt"))))
        for f in ("source.txt", "a.txt", "b.txt", "c.txt"):
            os.utime(os.path.join(root, f), (stamp, stamp))
        log = []
        _dag(module, root, log).run(os.path.join(root, "all"))
        assert log == ["all"], name


def test_same_cycle_raises_the_same_error(tmp_path):
    messages = {}
    for name, module in PACKAGES.items():
        ws = module.Workspace()
        ws.create_command_task("x", ["z"])
        ws.create_command_task("y", ["x"])
        with pytest.raises(ValueError) as exc_info:
            ws.create_command_task("z", ["y"])
        messages[name] = str(exc_info.value)
        with pytest.raises(ValueError, match="already defined"):
            ws.create_command_task("x", [])
        with pytest.raises(KeyError):
            ws.get_task(str(tmp_path / "no_such_file"))
    assert messages["port"] == messages["jax"]


def test_placeholder_task_needs_its_file(tmp_path):
    for module in PACKAGES.values():
        ws = module.Workspace()
        path = tmp_path / "plain.txt"
        path.write_text("x")
        task = ws.get_task(str(path))
        assert isinstance(task, module.PlaceholderTask) and not task.needs_to_run()
        assert task.timestamp() == os.path.getmtime(path)
        path.unlink()
        with pytest.raises(RuntimeError, match="does not exist"):
            task.timestamp()


@pytest.fixture
def config_file(tmp_path):
    return write_distiller_inputs(str(tmp_path / "inputs"), seed=4, batch_size=8, sample_cadence=10_000)


@pytest.mark.parametrize("flag", ["--list", "--tree"])
def test_tasks_cli_prints_the_jax_text(config_file, capsys, flag):
    """For the same config both CLIs list the same tasks with the same
    status, before and after the config yaml task has run."""
    texts = []
    for stage in range(2):
        assert jtasks_cli.main(["--config_file", config_file, flag]) == 0
        ref = capsys.readouterr().out
        assert tasks_cli.main(["--config_file", config_file, flag, "--device", "cpu"]) == 0
        ours = capsys.readouterr().out
        assert ours == ref
        texts.append(ours)
        if stage == 0:
            prefix = os.path.join(os.path.dirname(config_file), "job")
            assert tasks_cli.main(["--config_file", config_file, "--run", f"{prefix}/config.yaml", "--device", "cpu"]) == 0
            assert os.path.isfile(f"{prefix}/config.yaml")
    assert texts[0] != texts[1]  # the config yaml went from stale to up to date
    assert "module_module.npz" in texts[1] and "character_model.yaml" in texts[1] and "all" in texts[1]


def test_tasks_cli_interactive_shows_the_jax_tree(config_file, capsys, monkeypatch):
    """The numbered tree the selector loop shows, then quit."""
    monkeypatch.setattr("builtins.input", lambda prompt="": "q")
    assert jtasks_cli.main(["--config_file", config_file, "--interactive"]) == 0
    ref = capsys.readouterr().out
    assert tasks_cli.main(["--config_file", config_file, "--interactive", "--device", "cpu"]) == 0
    assert capsys.readouterr().out == ref
    assert "[1] " in ref

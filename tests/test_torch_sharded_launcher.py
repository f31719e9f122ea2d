"""``python -m repro_torch.launch.train --mesh N`` over gloo ranks on the
CPU with the sharded planes: ``--async-scoring`` and ``--stream`` print
the losses of the one-device run of the same flags; under
``--adaptive-is`` the ranks apply rank 0's swap cadence, which rank 0's
JSONL records and replays exactly; a ``--mesh 2 --save-checkpoint`` file
(gather-free) restores at ``--mesh 1`` and ``--mesh 4`` and resumes as
the uninterrupted one-device run.  Each mesh run is its own process
group of spawned ranks, so each runs in a subprocess.
"""
import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from _helpers import REPO  # noqa: E402
from repro_torch.core.controller import replay_decisions  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.telemetry.events import read_events  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

BASE = ["--smoke", "--device", "cpu", "--examples", "1024", "--log-every",
        "1"]
LOSS = re.compile(r"^step +(\d+) loss (\S+)")


def _mesh(argv, world):
    """The launcher at ``--mesh world`` in a subprocess; its stdout."""
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        *argv, "--mesh", str(world)], capture_output=True,
                       text=True, cwd=REPO, timeout=300,
                       env=dict(os.environ,
                                PYTHONPATH=os.path.join(REPO, "src"),
                                OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr[-3000:]
    assert f"mesh: ({world},)" in r.stdout
    return r.stdout


def _losses(text):
    return [m.group(2) for m in map(LOSS.match, text.splitlines()) if m]


def _one_device(argv, capsys):
    capsys.readouterr()
    ttrain.main(argv)
    return capsys.readouterr().out


@pytest.mark.parametrize("flags", [
    ["--async-scoring", "--swap-every", "2"],
    ["--stream"],
], ids=["async", "stream_sync"])
def test_launcher_mesh_plane_prints_the_one_device_losses(flags, capsys):
    argv = BASE + ["--steps", "6"] + flags
    got = _mesh(argv, 2)
    want = _one_device(argv + ["--score-shards", "2"], capsys)
    assert len(_losses(want)) == 6
    assert _losses(got) == _losses(want)


def test_launcher_mesh_adaptive_applies_what_rank0_records(tmp_path,
                                                           capsys):
    """``--mesh 2 --async-scoring --adaptive-is``: every decision rank 0
    prints is the one its JSONL records, the JSONL replays exactly, and
    the steps before the first decision can act are the one-device
    run's."""
    jsonl = str(tmp_path / "run.jsonl")
    argv = BASE + ["--steps", "6", "--async-scoring", "--swap-every", "2",
                   "--adaptive-is", "--adapt-every", "3"]
    got = _mesh(argv + ["--metrics-jsonl", jsonl], 2)
    events = read_events(jsonl)
    recorded = [(e["step"], e["use_is"], e["swap_every"])
                for e in events if e["kind"] == "controller.decision"]
    printed = [(int(s), u == "True", int(k)) for s, u, k in re.findall(
        r"controller: step (\d+) use_is=(\w+) swap_every=(\d+)", got)]
    assert len(recorded) == 2 and printed == recorded
    replayed = replay_decisions(events)
    assert [(d.step, d.use_is, d.swap_every) for d in replayed] == recorded
    want = _one_device(argv + ["--score-shards", "2"], capsys)
    assert _losses(got)[:3] == _losses(want)[:3]


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A ``--mesh 2`` async run of 3 steps saved gather-free (W = 4)."""
    ck = str(tmp_path_factory.mktemp("ck") / "ck.npz")
    argv = BASE + ["--score-shards", "4", "--async-scoring",
                   "--swap-every", "2"]
    out = _mesh(argv + ["--steps", "3", "--save-checkpoint", ck], 2)
    assert f"saved checkpoint to {ck}" in out
    return argv, ck, _losses(out)


@pytest.mark.parametrize("world", [1, 4])
def test_launcher_mesh_checkpoint_restores_at_another_world(saved, world,
                                                            capsys):
    argv, ck, first = saved
    want = _losses(_one_device(argv + ["--steps", "6"], capsys))
    assert first == want[:3]
    got = _mesh(argv + ["--steps", "3", "--restore-checkpoint", ck], world)
    assert "(step 3)" in got
    assert _losses(got) == want[3:]

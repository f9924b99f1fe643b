"""The port's training launcher (``python -m repro_torch.launch.train``):
the reference's failure drill (``tests/test_launch.py``) on the CPU, an
uninterrupted run, a run stopped at step 6 (exit 17) and its resume from
the step-5 checkpoint with the same ``loss[last 5]``; asynchronous
checkpoints give the same run; and without a card the default device
refuses, naming CUDA."""
import os
import subprocess
import sys
from pathlib import Path

SRC = str(Path(__file__).resolve().parents[1] / "src")
BASE = [
    sys.executable, "-m", "repro_torch.launch.train",
    "--arch", "stablelm-1.6b", "--reduced", "--batch", "2", "--seq", "16",
    "--steps", "10", "--ckpt-every", "5", "--log-every", "1",
]


def _run(args, **env):
    return subprocess.run(BASE + args, env=dict(os.environ, PYTHONPATH=SRC, **env), capture_output=True,
                          text=True, timeout=600)


def _final(out: str) -> str:
    return [line for line in out.splitlines() if line.startswith("final:")][0]


def test_failure_and_resume_drill(tmp_path):
    cpu = ["--device", "cpu"]
    ref = _run(cpu + ["--ckpt-dir", str(tmp_path / "ref")])
    assert ref.returncode == 0, ref.stderr[-2000:]
    assert sum(line.startswith("step ") for line in ref.stdout.splitlines()) == 10
    crash = _run(cpu + ["--ckpt-dir", str(tmp_path / "ft"), "--simulate-failure", "6", "--ckpt-async"])
    assert crash.returncode == 17, crash.stderr[-2000:]
    assert "[failure-sim] aborting at step 6" in crash.stdout
    assert sorted(os.listdir(tmp_path / "ft")) == ["step_00000005"]
    resume = _run(cpu + ["--ckpt-dir", str(tmp_path / "ft")])
    assert resume.returncode == 0, resume.stderr[-2000:]
    assert "[resume] restored step 5" in resume.stdout
    assert _final(ref.stdout).split("loss[last 5]=")[1] == _final(resume.stdout).split("loss[last 5]=")[1]


def test_the_default_device_needs_a_card(tmp_path):
    res = _run(["--ckpt-dir", str(tmp_path)], CUDA_VISIBLE_DEVICES="")
    assert res.returncode != 0 and "CUDA" in res.stderr
    assert "final:" not in res.stdout and not os.listdir(tmp_path)

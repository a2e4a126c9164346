"""The port's launcher (``python -m paddle_tpu_torch.distributed.launch``):
two ranks get the rank variables ``init_parallel_env`` reads (the
reference launcher's PADDLE_* names and torch's), and a failing rank's
exit code becomes the launcher's, its peer stopped (the watcher role of
``paddle_tpu/distributed/launch/main.py``); ``distributed.spawn`` sets
the same variables."""
import os
import subprocess
import sys
import time

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "workers"))
from torch_dist_worker import REPO, run_world, write_rank  # noqa: E402


def test_two_ranks_get_their_environment(tmp_path):
    envs = run_world(2, "launch_env", tmp_path)
    master = envs[0]["PADDLE_MASTER"]
    for r, env in enumerate(envs):
        assert env["RANK"] == env["PADDLE_TRAINER_ID"] == str(r)
        assert env["LOCAL_RANK"] == env["PADDLE_LOCAL_RANK"] == str(r)
        assert env["WORLD_SIZE"] == env["PADDLE_TRAINERS_NUM"] == "2"
        assert env["LOCAL_WORLD_SIZE"] == "2"
        assert env["PADDLE_MASTER"] == master == (
            f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}")


def test_a_failing_rank_fails_the_launch(tmp_path):
    with pytest.raises(RuntimeError, match="launcher exit 7"):
        run_world(2, "launch_env", tmp_path, fail_rank=1, exit_code=7)


def test_a_hung_peer_is_stopped(tmp_path):
    """Rank 1 fails at once while rank 0 sleeps: the launcher returns
    rank 1's code without waiting for rank 0."""
    script = tmp_path / "job.py"
    script.write_text(
        "import os, sys, time\n"
        "if os.environ['RANK'] == '1':\n"
        "    sys.exit(5)\n"
        "time.sleep(120)\n")
    t0 = time.monotonic()
    rc = subprocess.call(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--grace", "2", str(script)],
        cwd=REPO, timeout=90,
        env=dict(os.environ, PYTHONPATH=REPO), stderr=subprocess.DEVNULL)
    assert rc == 5
    assert time.monotonic() - t0 < 60


def test_spawn_sets_the_rank_variables(tmp_path):
    """``distributed.spawn`` (spawned processes, not forked) runs the
    target once a rank with the rank variables set."""
    import json

    from paddle_tpu_torch.distributed import spawn

    procs = spawn(write_rank, args=(str(tmp_path),), nprocs=2)
    assert [p.exitcode for p in procs] == [0, 0]
    for r in range(2):
        env = json.loads((tmp_path / f"spawn.{r}").read_text())
        assert env == {"RANK": str(r), "WORLD_SIZE": "2",
                       "LOCAL_RANK": str(r), "PADDLE_TRAINERS_NUM": "2"}

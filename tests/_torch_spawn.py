"""The multi-rank spawns of the port's CPU tests, in one place: `spawn`
starts a worker script's ranks from the VISPER_* environment on a
coordinator port that a running spawn cannot take (`distributed.free_port`:
below the kernel's ephemeral range, where gloo's pair listeners and every
other bind(0) of the suite's processes land), each rank logging to a file
of its own (a rank never blocks on a full pipe that no one reads); `wait`
gives every rank its time, stops the others at once when one fails (they
would wait on it in a collective) and fails with the failing rank's log.
No rank is left running.
"""

import os
import subprocess
import sys
import time

from visper_lm_tpu_torch.parallel.distributed import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spawn(worker: str, args, world: int, workdir, **env_extra):
    """Start `world` ranks of tests/<worker> with `args` (each logging to
    workdir/rank<r>.log); returns the processes."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("VISPER_")}
    env.update(VISPER_COORDINATOR=f"localhost:{free_port()}", VISPER_NUM_PROCESSES=str(world),
               OMP_NUM_THREADS="1")
    env.update(env_extra)
    path = os.path.join(REPO, "tests", worker)
    procs = []
    for r in range(world):
        with open(os.path.join(workdir, f"rank{r}.log"), "w") as log:
            procs.append(subprocess.Popen([sys.executable, path] + [str(a) for a in args],
                                          cwd=REPO, env=dict(env, VISPER_PROCESS_ID=str(r)),
                                          stdout=log, stderr=subprocess.STDOUT))
    return procs


def wait(procs, workdir, timeout: float):
    """Every rank's exit code 0 within `timeout` seconds; else an
    AssertionError with the first failing rank's log (a rank still running
    at the deadline is killed and reported so)."""
    deadline = time.monotonic() + timeout
    timed_out = False
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.2)
    finally:
        late = [r for r, p in enumerate(procs) if p.poll() is None]
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    # a rank that failed by itself first; then, after a timeout, the ranks
    # still running; then any rank that did not exit 0
    failed = ([r for r, p in enumerate(procs) if p.returncode not in (0, -9) and r not in late]
              or (late if timed_out else [])
              or [r for r, p in enumerate(procs) if p.returncode != 0])
    if failed:
        r = failed[0]
        with open(os.path.join(workdir, f"rank{r}.log")) as f:
            log = f.read()
        why = (f"did not finish within {timeout} s" if timed_out and r in late
               else f"exited {procs[r].returncode}")
        raise AssertionError(f"rank {r} {why}:\n{log[-4000:]}")

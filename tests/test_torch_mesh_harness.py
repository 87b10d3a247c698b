"""The gloo-rank harness of the port's parallel tests
(``tests/torch_mesh_workers.py``) under concurrent worlds.

Under the full suite's six test processes several worlds start at once.
Their ranks meet in a FileStore under each test's own tmp
(``rendezvous``), so no port is picked and released for another world to
take, and end with ``leave()`` (``os._exit`` once the results are written):
torch's c10d can abort in the interpreter's teardown under load (SIGABRT,
"terminate called without an active exception") after a rank's work is
done, which failed every test of the file whose fixture spawned that world.
Here four worlds of two and four ranks start together: every rank exits 0
and every all-reduce sums over its own world only.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from torch_mesh_workers import load, rendezvous, spawn

WORLDS = (2, 4, 2, 4)


def test_concurrent_worlds_meet_apart_and_exit_cleanly(tmp_path):
    dirs = [tmp_path / f"world{i}" for i in range(len(WORLDS))]
    for d in dirs:
        d.mkdir()
    with ThreadPoolExecutor(len(WORLDS)) as pool:
        for f in [pool.submit(spawn, "ping", d, w) for d, w in zip(dirs, WORLDS)]:
            f.result()          # spawn asserts each rank's exit code 0
    for d, w in zip(dirs, WORLDS):
        for rank in load(d, "ping", w):
            np.testing.assert_array_equal(rank["sum"], np.full(4, w * (w + 1) / 2))


def test_rendezvous_is_a_fresh_file_under_the_tmp(tmp_path):
    a, b = rendezvous(tmp_path), rendezvous(tmp_path)
    assert a != b and a.startswith(f"file://{tmp_path}/rendezvous-")

"""The port's threaded loader against the JAX package's, on the CPU.

Batch order and ``valid_count`` must equal the JAX loader's for
``shuffle``, ``drop_last`` and ``pad_partial`` over two epochs, with one
and with four reader threads; a consumer that stops early must leave no
reader thread behind, and a reader's exception must reach the consumer
without a hang. Every wait here has its own time limit (no pytest-timeout).
"""

import sys
import threading
import time

import numpy as np
import pytest

from geo_deep_learning_tpu.data.loader import DataLoader as JaxLoader
from geo_deep_learning_tpu_torch.data import loader as tloader
from geo_deep_learning_tpu_torch.data.datamodule import CSVDataModule
from geo_deep_learning_tpu_torch.data.loader import DataLoader

WAIT_S = 10.0


class Samples:
    """Sample i is ``{"image": [i, i], "name": "i"}``; reads take uneven times
    so that the threads finish out of order."""

    def __init__(self, n: int, fail_at: int | None = None) -> None:
        self.n = n
        self.fail_at = fail_at

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> dict:
        if i == self.fail_at:
            msg = f"cannot read sample {i}"
            raise OSError(msg)
        time.sleep(0.002 * (i % 3))
        return {"image": np.full(2, i), "name": str(i)}


def _loader_threads() -> list[threading.Thread]:
    return [t for t in threading.enumerate() if t.name.startswith(tloader.THREAD_PREFIX)]


def _wait_no_threads(limit: float = 5.0) -> list[threading.Thread]:
    end = time.monotonic() + limit
    while _loader_threads() and time.monotonic() < end:
        time.sleep(0.01)
    return _loader_threads()


def _bounded(fn):
    """Run ``fn`` in a thread for at most WAIT_S; returns (finished, result or error)."""
    out = {}

    def target():
        try:
            out["result"] = fn()
        except BaseException as err:  # handed to the test
            out["error"] = err

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(WAIT_S)
    return not t.is_alive(), out


@pytest.mark.parametrize("num_workers", [1, 4])
@pytest.mark.parametrize("mode", [dict(shuffle=True, drop_last=True), dict(pad_partial=True),
                                  dict(shuffle=True)], ids=["shuffle_drop_last", "pad_partial",
                                                            "shuffle_partial"])
def test_batches_match_the_jax_loader(mode, num_workers):
    jax_loader = JaxLoader(Samples(11), batch_size=4, num_workers=num_workers, seed=3, **mode)
    port = DataLoader(Samples(11), batch_size=4, num_workers=num_workers, seed=3, **mode)
    assert len(port) == len(jax_loader)
    for _ in range(2):
        want = list(jax_loader)
        finished, out = _bounded(lambda: list(port))
        assert finished and "error" not in out
        got = out["result"]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["image"], w["image"])
            assert g["name"] == w["name"]
            assert g["valid_count"] == w["valid_count"]
    assert _wait_no_threads() == []


def test_a_consumer_that_stops_early_leaves_no_thread():
    def one_batch():
        it = iter(DataLoader(Samples(64), batch_size=4, num_workers=4))
        batch = next(it)
        del it  # the generator is dropped with 15 batches to go
        return batch

    finished, out = _bounded(one_batch)
    assert finished and out["result"]["name"] == ["0", "1", "2", "3"]
    assert _wait_no_threads(5.0) == []


def test_a_reader_error_reaches_the_consumer():
    loader = DataLoader(Samples(40, fail_at=13), batch_size=4, num_workers=4)
    seen = []

    def consume():
        for batch in loader:
            seen.append(batch["name"])

    finished, out = _bounded(consume)
    assert finished, "the consumer hung"
    assert isinstance(out.get("error"), OSError) and "sample 13" in str(out["error"])
    # the batches before the failing one come in order, up to where it raised
    assert len(seen) <= 3
    assert seen == [[str(i) for i in range(b, b + 4)] for b in (0, 4, 8)][: len(seen)]
    assert _wait_no_threads() == []


def test_many_threads_with_fast_switching_keep_every_batch():
    """More readers than cores and a short switch interval: a lost update
    to the shared claim counter or a batch's sample count would drop,
    repeat or misplace a sample."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        port = DataLoader(Samples(203), batch_size=8, num_workers=32, pad_partial=True,
                          shuffle=True, seed=1)
        want = list(JaxLoader(Samples(203), batch_size=8, num_workers=4, pad_partial=True,
                              shuffle=True, seed=1))
        finished, out = _bounded(lambda: list(port))
    finally:
        sys.setswitchinterval(old)
    assert finished and "error" not in out
    assert [b["name"] for b in out["result"]] == [b["name"] for b in want]
    assert _wait_no_threads() == []


def test_datamodule_gives_every_loader_its_workers(tmp_path):
    for split in ("trn", "val", "tst"):
        (tmp_path / f"{split}.csv").write_text("a.tif;a_lbl.tif\n")
    default = CSVDataModule(str(tmp_path), str(tmp_path))
    default.setup("fit")
    assert default.num_workers == 8
    loaders = (default.train_dataloader(), default.val_dataloader(), default.test_dataloader())
    assert [dl.num_workers for dl in loaders] == [8, 8, 8]
    two = CSVDataModule(str(tmp_path), str(tmp_path), num_workers=2)
    two.setup("fit")
    assert two.test_dataloader().num_workers == 2

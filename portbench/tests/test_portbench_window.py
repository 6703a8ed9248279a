"""What the window holds: ``peak_mem_gb`` reads what the program keeps,
so the harness keeps no copy of its own of the weights through the
window (driven on the CPU at a tiny size)."""

import gc

import torch

from portbench.tests import tiny
from portbench.lib import harness as H
from portbench.lib import registry as REG
from portbench.lib import tap as T
from portbench.lib import weights as W


def test_the_local_sgd_window_holds_no_copy_of_the_seeds_weights(
        monkeypatch):
    """The loop's first outer step replaces the weights it was handed;
    by the time the window opens, every set of weights the harness made
    (for the warm-up, the timed call and the tap) is freed."""
    from torch.multiprocessing.reductions import StorageWeakRef
    made = []
    real_make = W.make

    def make(*a, **kw):
        tree = real_make(*a, **kw)
        made.extend(StorageWeakRef(W.get(tree, p).untyped_storage())
                    for p in W.paths(tree))
        return tree
    monkeypatch.setattr(W, "make", make)
    alive = []
    real_open = T.Window.open

    def open_(self):
        gc.collect()
        alive.append(sum(not r.expired() for r in made))
        real_open(self)
    monkeypatch.setattr(T.Window, "open", open_)
    w = tiny.cell("opt-1.3b.diloco-int8")
    ctx = H.Ctx(cell=w, conf=tiny.conf(w["config"]), seed=2147483711,
                seconds=0.0, trace=False, device=torch.device("cpu"))
    REG.traffic("local_sgd").run(ctx)
    assert made and alive == [0]

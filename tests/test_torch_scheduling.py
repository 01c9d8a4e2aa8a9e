"""The port's scheduling core (``repro_torch.core.scheduling``) and load
balancer (``repro_torch.core.scheduler.LoadBalancer``) against the
reference's. Both packages' modules are jax-free, so they are compared
directly: the same tasks, units, payload streams, windows and device
placements from the same inputs. The pool path runs against a stand-in
pool that records what it is asked, so no process is spawned here."""
import numpy as np
import pytest

from repro.core import scheduler as jsched
from repro.core import scheduling as jscheduling
from repro_torch.core import scheduler as tsched
from repro_torch.core import scheduling as tscheduling

MODS = {"port": (tscheduling, tsched), "reference": (jscheduling, jsched)}


def _tasks(mod):
    t = mod.BatchTask
    return [t(0, 1, 2), t(1, 3, 4, device=0), t(2, 5, 6, 1, generation=3),
            t(0, 7, 8, targets=np.array([5, 9], np.int32))]


def _args(task):
    return tuple(a.tolist() if isinstance(a, np.ndarray) else a
                 for a in task.pool_args())


def test_batch_tasks_address_the_same_work():
    port, ref = _tasks(tscheduling), _tasks(jscheduling)
    assert [_args(t) for t in port] == [_args(t) for t in ref]
    assert port[0].device == 0 and port[1].device == 0
    for a, b in zip(port, ref):
        for k in ("partition", "epoch", "index", "device", "generation"):
            assert getattr(a, k) == getattr(b, k)


def _units(mod, sched_mod, counts, epoch, gen=None):
    groups = list(sched_mod.iterations(sched_mod.two_stage_schedule(counts)))
    kw = {} if gen is None else {"gen_for_group": gen}
    return [([(a.iteration, a.device, a.partition, a.batch_index)
              for a in meta], [_args(t) for t in tasks])
            for meta, tasks in mod.EpochSource(groups, epoch, **kw).units()]


@pytest.mark.parametrize("counts", [[3], [4, 2, 5], [1, 6, 6, 2]])
def test_epoch_source_units_equal_reference(counts):
    assert (_units(tscheduling, tsched, counts, 4)
            == _units(jscheduling, jsched, counts, 4))
    gen = lambda gi: gi // 2  # noqa: E731
    got = _units(tscheduling, tsched, counts, 1, gen)
    assert got == _units(jscheduling, jsched, counts, 1, gen)
    assert [ts[0][4] for _, ts in got] == [gi // 2
                                           for gi in range(len(got))]


def _local(task):
    return {"coords": (task.partition, task.epoch, task.index, task.device)}


@pytest.mark.parametrize("which", sorted(MODS))
def test_local_stream_runs_tasks_in_unit_order(which):
    mod, sched_mod = MODS[which]
    groups = list(sched_mod.iterations(sched_mod.two_stage_schedule([2, 3])))
    core = mod.SchedulingCore(local_fn=_local)
    out = list(core.payload_stream(mod.EpochSource(groups, 2)))
    assert [len(p) for _, p in out] == [len(g) for g in groups]
    assert [p["coords"] for _, ps in out for p in ps] == [
        (a.partition, 2, a.batch_index, a.device) for g in groups for a in g]


class FakePool:
    """Stands in for a SamplerPool: runs tasks on submit, hands payloads
    back in submission order, and records how far ahead of the consumer
    the stream submitted."""

    def __init__(self):
        self.submitted, self.queue, self.max_ahead = [], [], 0

    def submit(self, *task):
        self.submitted.append(task[:4])
        self.queue.append({"task": task[:4]})
        self.max_ahead = max(self.max_ahead, len(self.queue))
        return len(self.submitted) - 1

    def fetch(self, timeout=60.0):
        return self.queue.pop(0)

    def map_tasks(self, tasks, window=None, fetch_timeout=300.0):
        window = window if window is not None else 4
        it = iter(tasks)
        exhausted = False
        while True:
            while not exhausted and len(self.queue) < window:
                try:
                    self.submit(*next(it))
                except StopIteration:
                    exhausted = True
            if exhausted and not self.queue:
                return
            yield self.fetch(fetch_timeout)


def _pool_stream(which, window):
    mod, sched_mod = MODS[which]
    groups = list(sched_mod.iterations(
        sched_mod.two_stage_schedule([3, 5, 2])))
    pool = FakePool()
    core = mod.SchedulingCore(pool=pool, window=window)
    out = [([(a.partition, a.batch_index) for a in meta],
            [p["task"] for p in ps])
           for meta, ps in core.payload_stream(mod.EpochSource(groups, 7))]
    return out, pool.submitted, pool.max_ahead


@pytest.mark.parametrize("window", [1, 3, 8])
def test_pool_stream_equals_reference(window):
    port, ref = _pool_stream("port", window), _pool_stream("reference",
                                                           window)
    assert port == ref
    out, submitted, ahead = port
    assert ahead <= window
    assert [t for _, ts in out for t in ts] == submitted


@pytest.mark.parametrize("which", sorted(MODS))
def test_request_units_submit_and_collect(which):
    mod, _ = MODS[which]
    pool = FakePool()
    core = mod.SchedulingCore(pool=pool)
    tasks = _tasks(mod)
    core.submit_unit("a", tasks[:2])
    core.submit_unit("b", tasks[2:])
    assert core.collect_unit() == ("a", [{"task": _args(t)[:4]}
                                         for t in tasks[:2]])
    meta, got = core.collect_unit(timeout=1.0)
    assert meta == "b" and len(got) == 2
    with pytest.raises(RuntimeError, match="no submitted units"):
        core.collect_unit()
    with pytest.raises(ValueError, match=">= 1"):
        core.submit_unit("c", [])
    local = mod.SchedulingCore(local_fn=_local)
    local.submit_unit("d", tasks[:1])
    assert local.collect_unit()[1] == [_local(tasks[0])]
    with pytest.raises(ValueError, match="local_fn"):
        mod.SchedulingCore()
    units = list(mod.IterableSource([("m", tasks[:1])]).units())
    assert units[0][0] == "m"


@pytest.mark.parametrize("p", [2, 3, 4])
def test_load_balancer_places_like_the_reference(p):
    rng = np.random.default_rng(p)
    port = tsched.LoadBalancer(p, "load")
    ref = jsched.LoadBalancer(p, "load")
    schedule = tsched.two_stage_schedule(list(rng.integers(1, 6, p)))
    for group in tsched.iterations(schedule):
        loads = [float(x) for x in rng.integers(1, 4, len(group)) * 10]
        loads = [tsched.LoadBalancer.batch_load(w, int(m), 16)
                 for w, m in zip(loads, rng.integers(0, 50, len(group)))]
        assert port.assign(group, loads) == ref.assign(group, loads)
    assert port.load == ref.load
    assert port.imbalance() == ref.imbalance()
    assert tsched.BALANCE_POLICIES == jsched.BALANCE_POLICIES
    rr = tsched.LoadBalancer(p)
    assert rr.assign(group, loads) == [a.device for a in group]
    with pytest.raises(ValueError, match="balance_policy"):
        tsched.LoadBalancer(p, "lpt")
    with pytest.raises(ValueError, match="more batches"):
        tsched.LoadBalancer(1, "load").assign(group + group, loads + loads)


def test_load_policy_puts_the_heaviest_batch_on_the_lightest_device():
    bal = tsched.LoadBalancer(3, "load")
    group = [tsched.Assignment(0, d, d, 0) for d in range(3)]
    assert bal.assign(group, [1.0, 5.0, 3.0]) == [2, 0, 1]
    # device 2 is now the lightest: the next heaviest batch goes there
    assert bal.assign(group, [2.0, 1.0, 9.0])[2] == 2
    assert tsched.LoadBalancer.batch_load(100.0, 3, 16) == 148.0

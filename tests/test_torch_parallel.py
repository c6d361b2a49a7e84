"""The port's multi-process runtime (fea_tpu_torch.parallel) on the CPU,
modelled on tests/test_distributed.py.

`ensure_initialized` with `init_process_group` mocked: its resolution
order (arguments, then fea_tpu's FEA_TPU_* names, then torchrun's), the
device made current before the group forms, the no-op that sticks; the
main-rank gate; `make_mesh` raising on a rank count the group cannot give;
each rank's rows of a micro-batch equal to those fea_tpu's `_fetch_batch`
feeds its process (mocked process count and index). Then real groups of
two gloo ranks, spawned by `parallel.launch` (each test bounds its own
time): the collectives, a rank's error surfacing with its traceback, a hang
killed at the launch's timeout, and a collective that a rank never joins
failing at the group's timeout. The ranks run tests/torch_dp_workers.py,
which imports no JAX. The `gpu` tests put two gloo ranks on one card, and
two NCCL ranks on two cards (skipped below two).
"""

import multiprocessing
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_dp_workers as workers
from fea_tpu_torch.parallel import distributed, launch, mesh

torch.set_num_threads(1)

CPU2 = ["cpu", "cpu"]
CLUSTER_ENV = ("FEA_TPU_COORDINATOR", "FEA_TPU_NUM_PROCESSES", "FEA_TPU_PROCESS_ID",
               "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


@pytest.fixture(autouse=True)
def _fresh_runtime(monkeypatch):
    for name in CLUSTER_ENV:
        monkeypatch.delenv(name, raising=False)
    saved = (distributed._DECIDED, distributed._DEVICE, distributed._HOST_GROUP)
    distributed._DECIDED = False
    yield
    distributed._DECIDED, distributed._DEVICE, distributed._HOST_GROUP = saved


def no_children_left():
    return not [p for p in multiprocessing.active_children() if p.name.startswith("fea-rank")]


JOINS = {
    # name: (environment, arguments, expected (init_method, world, rank, device))
    "arguments_first": (
        {"FEA_TPU_COORDINATOR": "10.0.0.1:1234", "FEA_TPU_NUM_PROCESSES": "4",
         "FEA_TPU_PROCESS_ID": "2", "MASTER_ADDR": "10.0.0.9", "WORLD_SIZE": "8", "RANK": "5"},
        dict(coordinator_address="file:///tmp/rdv", num_processes=3, process_id=1, device="cpu"),
        ("file:///tmp/rdv", 3, 1, "cpu")),
    "fea_tpu_names_before_torchrun": (
        {"FEA_TPU_COORDINATOR": "10.0.0.1:1234", "FEA_TPU_NUM_PROCESSES": "4",
         "FEA_TPU_PROCESS_ID": "2", "MASTER_ADDR": "10.0.0.9", "MASTER_PORT": "29500",
         "WORLD_SIZE": "8", "RANK": "5"},
        dict(device="cpu"),
        ("tcp://10.0.0.1:1234", 4, 2, "cpu")),
    "torchrun": (
        {"MASTER_ADDR": "10.0.0.9", "MASTER_PORT": "29500", "WORLD_SIZE": "8", "RANK": "5",
         "LOCAL_RANK": "1"},
        {},
        ("env://", 8, 5, "cuda:1")),
    "torchrun_cuda_without_index": (
        {"MASTER_ADDR": "10.0.0.9", "MASTER_PORT": "29500", "WORLD_SIZE": "8", "RANK": "5",
         "LOCAL_RANK": "1"},
        dict(device="cuda"),
        ("env://", 8, 5, "cuda:1")),
}


@pytest.mark.parametrize("case", JOINS)
def test_ensure_initialized_resolution_order(case, monkeypatch):
    env, kwargs, (init_method, world, rank, device) = JOINS[case]
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    calls = []
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.append(("set_device", str(d))))
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: calls.append(("init", backend, kw)))
    monkeypatch.setattr(torch.distributed, "new_group",
                        lambda **kw: calls.append(("new_group", kw["backend"])) or "host")
    assert distributed.ensure_initialized(**kwargs) is True
    cuda = device.startswith("cuda")
    inits = [c for c in calls if c[0] == "init"]
    assert len(inits) == 1
    _, backend, kw = inits[0]
    assert (kw["init_method"], kw["world_size"], kw["rank"]) == (init_method, world, rank)
    assert backend == ("nccl" if cuda else "gloo")
    assert kw["timeout"].total_seconds() == distributed.DEFAULT_TIMEOUT_S
    assert str(distributed._DEVICE) == device
    if cuda:  # the device is current before the group forms; host tensors ride gloo
        assert calls[0] == ("set_device", device) and calls[2] == ("new_group", "gloo")
        assert distributed.host_group() == "host"
    else:
        assert distributed.host_group() is None
    # sticky: a second call joins nothing more
    distributed.ensure_initialized(**kwargs)
    assert len([c for c in calls if c[0] == "init"]) == 1


def test_single_process_noop_sticks(monkeypatch):
    """No cluster named: no group, no device touched, and the decision
    sticks; the queries and the barrier are no-ops, the view is 1 rank."""
    def boom(*args, **kw):
        raise AssertionError("init_process_group must not be called")

    monkeypatch.setattr(torch.distributed, "init_process_group", boom)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert distributed.ensure_initialized() is False
    monkeypatch.setenv("FEA_TPU_COORDINATOR", "10.0.0.1:1234")
    assert distributed.ensure_initialized() is False
    assert (distributed.process_count(), distributed.process_index()) == (1, 0)
    assert distributed.is_main_process()
    distributed.sync_processes()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.local_device()
    view = mesh.make_mesh(None, "cpu")
    assert (view.world_size, view.rank, view.device, view.distributed) == (
        1, 0, torch.device("cpu"), False)
    assert view.rows(6) == slice(0, 6)
    grads = [torch.ones(2)]
    mesh.all_reduce_mean(grads)
    assert torch.equal(grads[0], torch.ones(2))
    assert torch.equal(mesh.gather_rows(torch.ones(2, 3)), torch.ones(2, 3))


def test_a_group_without_its_size_raises(monkeypatch):
    monkeypatch.setenv("FEA_TPU_COORDINATOR", "10.0.0.1:1234")
    with pytest.raises(ValueError, match="number of processes"):
        distributed.ensure_initialized(device="cpu")


def test_is_main_process_gate(monkeypatch):
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 3)
    assert distributed.is_main_process() is False
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 0)
    assert distributed.is_main_process() is True


def test_make_mesh_raises_on_a_mismatch(monkeypatch):
    with pytest.raises(ValueError, match="no process group.*torchrun --nproc_per_node 2"):
        mesh.make_mesh(2, "cpu")
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 4)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 1)
    with pytest.raises(ValueError, match="has 4 ranks.*torchrun"):
        mesh.make_mesh(2, "cpu")
    view = mesh.make_mesh(None, "cpu")
    assert view == mesh.make_mesh(4, "cpu")
    assert (view.world_size, view.rank, view.distributed) == (4, 1, True)
    assert view.rows(8) == slice(2, 4)
    with pytest.raises(ValueError, match="must divide over 4 ranks"):
        view.rows(6)


@pytest.mark.parametrize("world,rank", [(2, 0), (2, 1), (4, 3)])
def test_rank_rows_are_fea_tpus_process_rows(world, rank, monkeypatch):
    """Each rank feeds the rows of every micro-batch that fea_tpu's
    `_fetch_batch` feeds the process of the same index (process-major:
    rank r owns [r B / W, (r + 1) B / W))."""
    from fea_tpu.train import trainer as jtrainer
    from fea_tpu_torch.train.trainer import Trainer

    def fake(seen, **kw):
        class RecordingDataset:
            def __getitem__(self, i):
                seen.append(int(i))
                return {"x": np.zeros((2,), np.float32)}

        return SimpleNamespace(
            config=SimpleNamespace(train_batch_size=8, num_gradient_accumulation_steps=3),
            sampler=SimpleNamespace(indices_at=lambda off, count: np.arange(off, off + count)),
            device_tables=None, dataset=RecordingDataset(), **kw)

    theirs = []
    monkeypatch.setattr(jtrainer, "shard_batch", lambda mesh, batch, leading_unsharded=0: batch)
    monkeypatch.setattr(jtrainer.jax, "process_count", lambda: world)
    monkeypatch.setattr(jtrainer.jax, "process_index", lambda: rank)
    jbatch = jtrainer.Trainer._fetch_batch(fake(theirs, mesh=None, _pack_transfer=lambda b: b), 24)

    ours = []
    dp = mesh.DataParallel(world, rank, torch.device("cpu"), True)
    batch = Trainer._fetch_batch(fake(ours, dp=dp, _to_device=lambda t: t,
                                      _pack_transfer=lambda b: {k: torch.from_numpy(v)
                                                                for k, v in b.items()}), 24)
    assert ours == theirs and len(ours) == 3 * 8 // world
    assert tuple(batch["x"].shape) == jbatch["x"].shape == (3, 8 // world, 2)


def test_collectives_over_two_gloo_ranks():
    """all_reduce_mean gives each rank the mean, gather_rows every rank's
    rows in rank order, replicate rank 0's values (one bucket per dtype)."""
    results = launch(workers.collectives, 2, (3,), devices=CPU2, timeout_s=120)
    rows = torch.arange(6, dtype=torch.float32).reshape(3, 2)
    for rank, out in enumerate(results):
        assert out["world"] == 2 and out["device"] == "cpu"
        assert out["view"] == (2, rank, "cpu", True)
        assert torch.equal(out["grads"][0], torch.full((3,), 0.5))
        assert torch.equal(out["grads"][1], torch.tensor(1.0))
        assert torch.equal(out["rows"], torch.cat([rows, rows + 100]))
        assert torch.equal(out["weights"][0], torch.ones(2, 2))
        assert out["weights"][1].dtype == torch.int32 and int(out["weights"][1]) == 7
    assert no_children_left()


def test_launch_surfaces_a_rank_error():
    with pytest.raises(RuntimeError, match="(?s)rank 1 of 2 failed.*rank 1 fails on purpose"):
        launch(workers.fail_on_rank_one, 2, devices=CPU2, timeout_s=120)
    assert no_children_left()


def test_launch_kills_a_hang():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"ranks \[0, 1\] did not finish within 6"):
        launch(workers.hang, 2, devices=CPU2, timeout_s=6)
    assert time.monotonic() - t0 < 30
    assert no_children_left()


def test_a_hung_collective_fails_within_its_timeout():
    """An all_reduce that rank 1 never joins fails rank 0 at the group's
    timeout (2 s), long before the launch's own (120 s)."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 0 of 2 failed"):
        launch(workers.skip_a_collective, 2, (2.0,), devices=CPU2, timeout_s=120)
    assert time.monotonic() - t0 < 60
    assert no_children_left()


@pytest.mark.gpu
def test_two_gloo_ranks_share_one_card():
    """gloo carries CUDA tensors for all_reduce and broadcast, and
    gather_rows goes through the host: two ranks on cuda:0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    results = launch(workers.collectives, 2, (3,), devices=["cuda:0", "cuda:0"], backend="gloo",
                     timeout_s=300)
    for rank, out in enumerate(results):
        assert out["device"] == "cuda:0" and out["view"] == (2, rank, "cuda:0", True)
        assert torch.equal(out["grads"][0], torch.full((3,), 0.5))
        assert torch.equal(out["weights"][0], torch.ones(2, 2)) and int(out["weights"][1]) == 7
        assert out["rows"].shape == (6, 2)


@pytest.mark.gpu
def test_two_nccl_ranks_on_two_cards():
    if torch.cuda.device_count() < 2:
        pytest.skip(f"needs 2 CUDA devices, {torch.cuda.device_count()} visible: the NCCL "
                    "run of two ranks waits for a machine with two cards")
    results = launch(workers.collectives, 2, (3,), timeout_s=300)
    for rank, out in enumerate(results):
        assert out["device"] == f"cuda:{rank}" and out["view"] == (2, rank, f"cuda:{rank}", True)
        assert torch.equal(out["grads"][0], torch.full((3,), 0.5))
        assert torch.equal(out["weights"][0], torch.ones(2, 2)) and int(out["weights"][1]) == 7

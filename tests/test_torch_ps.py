"""The port's parameter-server stack (``paddle_tpu_torch.distributed.ps``
and ``fleet``'s parameter-server mode) against the JAX package's.

Servers run in this process (threaded RPC loops), as in
``tests/test_ps.py``, whose cases each have their port counterpart
here.  The wire format and the table files are shared: the port's client
drives a JAX server and the JAX client a port server, and tables saved
by one package load in the other, with pulls, pushes and rows equal
bit for bit (the same float32 numpy operations on both sides).
``SparseEmbedding`` and ``GeoTrainer`` train from the same seeded rows
and weights as the JAX package's: fp32, losses within rtol 1e-6 and
parameters within atol 1e-6 (the gathers and the optimizer are the
same operations; the port's backward sums a repeated row's gradients in
torch's order).
"""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest

import paddle_tpu_torch as paddle
from paddle_tpu_torch.distributed import ps
from paddle_tpu_torch.distributed.ps import (GeoTrainer, ParameterServer,
                                             PSClient, SparseEmbedding)


@pytest.fixture(autouse=True)
def _cpu():
    from paddle_tpu_torch import device as tdevice
    prev = tdevice._CURRENT[0]
    paddle.set_device("cpu")
    yield
    tdevice._CURRENT[0] = prev


@pytest.fixture
def server():
    s = ParameterServer(port=0).start()
    yield s
    s.stop()


@pytest.fixture
def two_servers():
    ss = [ParameterServer(port=0).start() for _ in range(2)]
    yield ss
    for s in ss:
        s.stop()


def _mean(t):
    """``t.mean()``; the port's Tensor has no reductions yet, so its mean
    is torch's on the wrapped data, inside the same graph."""
    if isinstance(t, paddle.Tensor):
        return paddle.Tensor._wrap(t._data.mean())
    return t.mean()


def _pkg(name):
    if name == "jax":
        from paddle_tpu.distributed import ps as jps
        return jps
    return ps


# -- the port's counterparts of tests/test_ps.py -----------------------------

def test_sparse_pull_push_roundtrip(server):
    c = PSClient([server.endpoint])
    c.create_sparse_table("emb", 4, initializer="zeros")
    ids = np.array([3, 7, 3])
    vals = c.pull_sparse("emb", ids)
    assert vals.shape == (3, 4)
    np.testing.assert_array_equal(vals, 0)
    c.push_sparse("emb", ids, np.ones((3, 4), np.float32), lr=0.1)
    after = c.pull_sparse("emb", np.array([3, 7]))
    np.testing.assert_allclose(after[0], -0.2, rtol=1e-6)
    np.testing.assert_allclose(after[1], -0.1, rtol=1e-6)
    c.close()


def test_dense_grad_and_delta(server):
    c = PSClient([server.endpoint])
    c.create_dense_table("w", (2, 3))
    np.testing.assert_array_equal(c.pull_dense("w"), 0)
    c.push_dense_grad("w", np.ones((2, 3), np.float32), lr=0.5)
    np.testing.assert_allclose(c.pull_dense("w"), -0.5)
    c.push_dense_delta("w", np.full((2, 3), 0.5, np.float32))
    np.testing.assert_allclose(c.pull_dense("w"), 0.0)
    c.close()


def test_sharded_sparse_routing(two_servers):
    """ids shard by ``id % num_servers``: evens on server 0, odds on 1."""
    c = PSClient([s.endpoint for s in two_servers])
    c.create_sparse_table("emb", 2, initializer="zeros")
    ids = np.arange(10)
    c.push_sparse("emb", ids, np.ones((10, 2), np.float32), lr=1.0)
    assert len(two_servers[0].tables["emb"]) == 5
    assert len(two_servers[1].tables["emb"]) == 5
    assert sorted(two_servers[1].tables["emb"]._slot) == [1, 3, 5, 7, 9]
    np.testing.assert_allclose(c.pull_sparse("emb", ids), -1.0)
    assert c.sparse_table_size("emb") == 10
    c.close()


def _seed_rows(c, table, rows):
    """Set ``table``'s rows 0..V-1 to ``rows`` (an SGD push of the
    difference at lr 1)."""
    V = len(rows)
    c.push_sparse(table, np.arange(V),
                  -(rows - c.pull_sparse(table, np.arange(V))), lr=1.0)


def _embedding_run(pkg_name, endpoint, table0, targets, ids_np, lr=0.5,
                   steps=5):
    P = _pkg(pkg_name)
    if pkg_name == "jax":
        import paddle_tpu as tp
    else:
        tp = paddle
    c = P.PSClient([endpoint])
    emb = P.SparseEmbedding("emb", len(table0), table0.shape[1],
                            ps_client=c, optimizer="sgd")
    _seed_rows(c, "emb", table0)
    ids = tp.to_tensor(ids_np.astype(np.int64))
    tgt = tp.to_tensor(targets)
    losses = []
    for _ in range(steps):
        out = emb(ids)
        loss = _mean((out - tgt) ** 2)
        loss.backward()
        losses.append(float(loss.numpy()))
        emb.push_step(lr=lr)
    rows = c.pull_sparse("emb", np.arange(len(table0)))
    c.close()
    return losses, rows


def _embedding_data():
    rng = np.random.RandomState(0)
    V, D, B = 20, 8, 16
    table0 = rng.standard_normal((V, D)).astype(np.float32) * 0.1
    targets = rng.standard_normal((B, D)).astype(np.float32)
    ids_np = rng.randint(0, V, size=(B,))
    return table0, targets, ids_np


def test_sparse_embedding_trains_vs_dense_twin(server):
    """The PS-backed embedding follows a dense embedding's trajectory
    under plain SGD (the numpy twin of ``tests/test_ps.py``)."""
    table0, targets, ids_np = _embedding_data()
    w = table0.copy()
    ref_losses = []
    for _ in range(5):
        diff = w[ids_np] - targets
        ref_losses.append(float((diff ** 2).mean()))
        g = np.zeros_like(w)
        np.add.at(g, ids_np, 2.0 * diff / diff.size)
        w -= 0.5 * g
    losses, rows = _embedding_run("port", server.endpoint, table0, targets,
                                  ids_np)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    np.testing.assert_allclose(rows, w, atol=1e-6)
    assert losses[-1] < losses[0]


def test_sparse_embedding_matches_jax(server):
    """The same seeded rows and batch through the JAX package's
    ``SparseEmbedding`` (on a JAX server) and the port's: losses within
    rtol 1e-6, final rows within atol 1e-6; the port's forward lands one
    leaf of the unique rows that needs a gradient."""
    from paddle_tpu.distributed.ps import ParameterServer as JServer
    table0, targets, ids_np = _embedding_data()
    js = JServer(port=0).start()
    try:
        jl, jrows = _embedding_run("jax", js.endpoint, table0, targets,
                                   ids_np)
    finally:
        js.stop()
    pl, prows = _embedding_run("port", server.endpoint, table0, targets,
                               ids_np)
    np.testing.assert_allclose(pl, jl, rtol=1e-6)
    np.testing.assert_allclose(prows, jrows, atol=1e-6)
    c = PSClient([server.endpoint])
    emb = SparseEmbedding("leaf", 20, 8, ps_client=c)
    out = emb(paddle.to_tensor(np.array([[3, 5], [5, 9]], np.int64)))
    assert tuple(out.shape) == (2, 2, 8)
    assert emb._pulled.is_leaf and emb._pulled.requires_grad
    assert tuple(emb._pulled.shape) == (3, 8)
    c.close()


def test_geo_trainer_syncs_every_k(server):
    c = PSClient([server.endpoint])
    lin = paddle.nn.Linear(4, 4)
    geo = GeoTrainer("geo_lin", lin.parameters(), k_steps=3, ps_client=c)
    opt = paddle.optimizer.SGD(learning_rate=0.1,
                               parameters=lin.parameters())
    x = paddle.to_tensor(np.random.RandomState(1)
                         .standard_normal((8, 4)).astype(np.float32))
    synced = []
    for _ in range(6):
        loss = _mean(lin(x) ** 2)
        loss.backward()
        opt.step()
        opt.clear_grad()
        synced.append(geo.step())
    assert synced == [False, False, True, False, False, True]
    np.testing.assert_allclose(c.pull_dense("geo_lin.0"),
                               lin.parameters()[0].numpy(), atol=1e-6)
    c.close()


def _geo_two_workers(pkg_name, endpoint, w0, b0, x_np, y_np):
    P = _pkg(pkg_name)
    if pkg_name == "jax":
        import paddle_tpu as tp
    else:
        tp = paddle
    x, y = tp.to_tensor(x_np), tp.to_tensor(y_np)
    workers = []
    for _ in range(2):
        c = P.PSClient([endpoint])
        lin = tp.nn.Linear(4, 2)
        lin.weight.set_value(w0)
        lin.bias.set_value(b0)
        geo = P.GeoTrainer("geo2", lin.parameters(), k_steps=2, ps_client=c)
        opt = tp.optimizer.SGD(learning_rate=0.05,
                               parameters=lin.parameters())
        workers.append((c, lin, geo, opt))
    losses = []
    for _ in range(8):
        for c, lin, geo, opt in workers:
            loss = _mean((lin(x) - y) ** 2)
            loss.backward()
            opt.step()
            opt.clear_grad()
            geo.step()
            losses.append(float(loss.numpy()))
    for _, _, geo, _ in workers:
        geo.sync()
    for _, _, geo, _ in workers:
        geo.sync()
    params = [[np.asarray(p.numpy()) for p in w[1].parameters()]
              for w in workers]
    for c, *_ in workers:
        c.close()
    return losses, params


def test_geo_two_workers_converge_to_jax(server):
    """Two geo workers sharing one server: decreasing loss, equal final
    parameters, and the JAX package's values for the same start."""
    from paddle_tpu.distributed.ps import ParameterServer as JServer
    rng = np.random.RandomState(2)
    x = rng.standard_normal((16, 4)).astype(np.float32)
    y = rng.standard_normal((16, 2)).astype(np.float32)
    w0 = rng.standard_normal((4, 2)).astype(np.float32) * 0.5
    b0 = np.zeros(2, np.float32)
    pl, pp = _geo_two_workers("port", server.endpoint, w0, b0, x, y)
    js = JServer(port=0).start()
    try:
        jl, jp_ = _geo_two_workers("jax", js.endpoint, w0, b0, x, y)
    finally:
        js.stop()
    assert pl[-1] < pl[0]
    for a, b in zip(pp[0], pp[1]):
        np.testing.assert_allclose(a, b, atol=1e-5)
    np.testing.assert_allclose(pl, jl, rtol=1e-6)
    for mine, theirs in zip(pp, jp_):
        for a, b in zip(mine, theirs):
            np.testing.assert_allclose(a, b, atol=1e-6)


def test_save_load_roundtrip(server, tmp_path):
    c = PSClient([server.endpoint])
    c.create_sparse_table("emb", 3)
    c.create_dense_table("w", (2, 2))
    ids = np.array([1, 5, 9])
    before = c.pull_sparse("emb", ids)
    c.push_dense_grad("w", np.ones((2, 2), np.float32), lr=1.0)
    c.save(str(tmp_path))
    c.push_sparse("emb", ids, np.ones((3, 3), np.float32), lr=10.0)
    c.push_dense_delta("w", np.ones((2, 2), np.float32))
    c.load(str(tmp_path))
    np.testing.assert_array_equal(c.pull_sparse("emb", ids), before)
    np.testing.assert_allclose(c.pull_dense("w"), -1.0)
    c.close()


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad"])
def test_table_push_matches_jax_table(optimizer):
    """The port's table (one block update a push) and the JAX table (a
    loop a row) from the same rows give the same rows bit for bit, for
    each optimizer, over pushes with repeated and new ids."""
    from paddle_tpu.distributed.ps.table import SparseTable as J
    from paddle_tpu_torch.distributed.ps.table import SparseTable as P
    rng = np.random.RandomState(3)
    mine, theirs = (cls("emb", 8, initializer="zeros", optimizer=optimizer)
                    for cls in (P, J))
    start = rng.standard_normal((40, 8)).astype(np.float32)
    for t in (mine, theirs):
        t.pull(np.arange(40))
        t.push(np.arange(40), -start, lr=1.0)
    for _ in range(5):
        ids = rng.randint(0, 60, 50)
        grads = rng.standard_normal((50, 8)).astype(np.float32)
        for t in (mine, theirs):
            t.push(ids, grads, lr=0.1)
    ids = np.arange(60)
    np.testing.assert_array_equal(mine.pull(ids), theirs.pull(ids))


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad"])
def test_table_memory_bounded_by_rows(optimizer):
    """A table's memory grows with its rows, not with its pushes: 300
    pushes of a hot set of 64 rows and one new row each leave at most
    twice the rows' bytes (the array's doubling) times the arrays an
    optimizer keeps, plus 64 KiB."""
    import tracemalloc
    from paddle_tpu_torch.distributed.ps.table import SparseTable
    dim, hot = 64, np.arange(64)
    t = SparseTable("emb", dim, optimizer=optimizer)
    grads = np.ones((hot.size + 1, dim), np.float32)
    tracemalloc.start()
    try:
        base = tracemalloc.get_traced_memory()[0]
        for step in range(300):
            t.push(np.append(hot, 1000 + step), grads, lr=0.01)
        held = tracemalloc.get_traced_memory()[0] - base
    finally:
        tracemalloc.stop()
    arrays = 1 + (optimizer == "adagrad")
    bound = 2 * len(t) * dim * 4 * arrays
    assert len(t) == hot.size + 300
    assert held <= bound + (64 << 10), (held, bound)


def test_fleet_ps_roles_and_lifecycle():
    """fleet.init_server/run_server/init_worker/stop_worker wiring
    (reference: fleet.py:937,1038)."""
    from paddle_tpu_torch.distributed import fleet
    ps.init(role="pserver")
    assert fleet.is_server() and not fleet.is_worker()
    srv = fleet.init_server()
    t = threading.Thread(target=fleet.run_server, daemon=True)
    t.start()
    ps.init(role="trainer")
    assert fleet.is_worker()
    fleet.init_worker(endpoints=[srv.endpoint])
    ps.client().create_sparse_table("e", 2)
    assert ps.client().pull_sparse("e", np.array([0])).shape == (1, 2)
    fleet.stop_worker()
    t.join(timeout=10)
    assert not t.is_alive()


def test_fleet_role_maker_path(monkeypatch):
    """``TRAINING_ROLE=PSERVER`` then ``fleet.init(PaddleCloudRoleMaker())``
    makes a server without a process group or a mesh; a trainer's
    ``fleet.init`` builds the collective mesh.  The JAX package's
    ``PaddleCloudRoleMaker`` answers ``is_server()`` False under the same
    environment (ROADMAP.md C)."""
    from paddle_tpu.distributed import fleet as jfleet
    from paddle_tpu_torch.distributed import env, fleet
    monkeypatch.setenv("TRAINING_ROLE", "PSERVER")
    monkeypatch.setenv("PADDLE_PORT", "0")
    monkeypatch.setenv("PADDLE_PSERVERS_IP_PORT_LIST",
                       "127.0.0.1:1,127.0.0.1:2")
    assert not jfleet.PaddleCloudRoleMaker().is_server()
    rm = fleet.PaddleCloudRoleMaker()
    assert rm.is_server() and not rm.is_worker()
    assert rm.get_pserver_endpoints() == ["127.0.0.1:1", "127.0.0.1:2"]
    try:
        assert fleet.init(rm) is None
        assert fleet.is_server() and env.get_mesh() is None
        assert not env.is_initialized()
        srv = fleet.init_server()
        t = threading.Thread(target=fleet.run_server, daemon=True)
        t.start()
        monkeypatch.setenv("TRAINING_ROLE", "TRAINER")
        urm = fleet.UserDefinedRoleMaker(role=fleet.Role.WORKER,
                                         server_endpoints=[srv.endpoint])
        hcg = fleet.init(urm)
        assert fleet.is_worker() and hcg is not None
        assert env.get_mesh().shape["dp"] == 1
        fleet.init_worker([srv.endpoint])
        ps.client().create_dense_table("d", (2,))
        np.testing.assert_array_equal(ps.client().pull_dense("d"), 0)
        fleet.stop_worker()
        t.join(timeout=10)
        assert not t.is_alive()
    finally:
        fleet._reset()
        ps._CTX.role_maker = ps._CTX.server = None


def test_dense_init_once_is_atomic(server):
    c = PSClient([server.endpoint])
    c.create_dense_table("seed_t", (4,))
    results = []
    lock = threading.Lock()

    def worker(i):
        cc = PSClient([server.endpoint])
        won = cc.dense_init_once("seed_t", np.full(4, float(i + 1),
                                                   np.float32))
        with lock:
            results.append((i, won))
        cc.close()

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    [t.start() for t in ts]
    [t.join() for t in ts]
    winners = [i for i, won in results if won]
    assert len(winners) == 1
    np.testing.assert_allclose(c.pull_dense("seed_t"),
                               float(winners[0] + 1))
    c.close()


class _FakeSock:
    def __init__(self, buf):
        import io
        self._b = io.BytesIO(buf)

    def recv(self, n):
        return self._b.read(n)


def test_rpc_many_arrays_roundtrip_and_wire_bytes():
    """More than 10 arrays in one message keep their order, and the
    port's bytes are the JAX package's, byte for byte, each decoding the
    other's."""
    from paddle_tpu.distributed.ps import rpc as jrpc
    from paddle_tpu_torch.distributed.ps import rpc
    msg = {"op": "push_sparse", "lr": 0.5, "n": np.int64(3),
           "arrs": [np.full((2, 2), i, np.float32) for i in range(13)],
           "ids": np.arange(5, dtype=np.int64)}
    raw = rpc._encode(msg)
    assert raw == jrpc._encode(msg)
    for dec in (rpc._decode, jrpc._decode):
        out = dec(_FakeSock(raw))
        for i, a in enumerate(out["arrs"]):
            np.testing.assert_array_equal(a, np.full((2, 2), i, np.float32))
        np.testing.assert_array_equal(out["ids"], np.arange(5))
        assert out["n"] == 3 and out["lr"] == 0.5


# -- across the two packages --------------------------------------------------

def _wire_scenario(client):
    """A fixed sequence of creates, pulls and pushes; returns what the
    client saw."""
    client.create_sparse_table("emb", 4, initializer="zeros")
    client.create_sparse_table("ada", 3, initializer="zeros",
                               optimizer="adagrad")
    client.create_dense_table("w", (2, 3))
    ids = np.array([4, 7, 4, 10, 1])
    g = np.arange(20, dtype=np.float32).reshape(5, 4) / 7
    seen = [client.pull_sparse("emb", ids)]
    client.push_sparse("emb", ids, g, lr=0.3)
    seen.append(client.pull_sparse("emb", np.arange(12)))
    client.push_sparse("ada", ids, g[:, :3], lr=0.1)
    client.push_sparse("ada", ids[::-1], g[:, 1:], lr=0.1)
    seen.append(client.pull_sparse("ada", np.arange(12)))
    client.push_dense_grad("w", np.ones((2, 3), np.float32) / 3, lr=0.7)
    client.push_dense_delta("w", np.full((2, 3), 0.25, np.float32))
    seen.append(client.pull_dense("w"))
    seen.append(np.array([client.sparse_table_size("emb"),
                          client.dense_init_once("w", np.zeros((2, 3)))]))
    return seen


@pytest.mark.parametrize("client_pkg,server_pkg",
                         [("port", "jax"), ("jax", "port")])
def test_wire_across_packages(client_pkg, server_pkg):
    """One package's client drives the other's two servers: every pull
    equals a same-package pair's, bit for bit."""
    def run(cp, sp):
        servers = [_pkg(sp).ParameterServer(port=0).start()
                   for _ in range(2)]
        try:
            c = _pkg(cp).PSClient([s.endpoint for s in servers])
            seen = _wire_scenario(c)
            c.stop_servers()
            c.close()
        finally:
            for s in servers:
                s.stop()
        return seen
    got = run(client_pkg, server_pkg)
    want = run(server_pkg, server_pkg)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_tables_load_across_packages(writer, reader, tmp_path):
    """Tables one package's servers saved load in the other's: the same
    rows, the same dense values."""
    servers = [_pkg(writer).ParameterServer(port=0).start()
               for _ in range(2)]
    c = _pkg(writer).PSClient([s.endpoint for s in servers])
    c.create_sparse_table("emb", 5)
    c.create_dense_table("w", (3,), initializer="normal")
    ids = np.array([2, 9, 11, 4])
    rows = c.pull_sparse("emb", ids)
    c.push_sparse("emb", ids, np.ones((4, 5), np.float32), lr=0.5)
    rows_after = c.pull_sparse("emb", ids)
    dense = c.pull_dense("w")
    c.save(str(tmp_path))
    c.close()
    for s in servers:
        s.stop()
    servers = [_pkg(reader).ParameterServer(port=0).start()
               for _ in range(2)]
    try:
        r = _pkg(reader).PSClient([s.endpoint for s in servers])
        r.create_sparse_table("emb", 5)
        r.create_dense_table("w", (3,))
        r.load(str(tmp_path))
        np.testing.assert_array_equal(r.pull_sparse("emb", ids), rows_after)
        np.testing.assert_array_equal(r.pull_dense("w"), dense)
        assert not np.array_equal(rows, rows_after)
        assert r.sparse_table_size("emb") == 4
        r.close()
    finally:
        for s in servers:
            s.stop()


_HASH_PROBE = """
import sys
from paddle_tpu_torch.distributed.ps.table import SparseTable as P
from paddle_tpu.distributed.ps.table import SparseTable as J
print(repr((P("emb", 4).pull([0]).tolist(), J("emb", 4).pull([0]).tolist())))
"""


def test_row_seed_is_stable_across_processes():
    """The port seeds a table's rows with a stable hash of its name: two
    processes with different ``PYTHONHASHSEED`` draw the same first row.
    The JAX package's ``hash(name)`` draws different ones
    (ROADMAP.md C)."""
    import ast
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rows = []
    for seed in ("1", "2"):
        r = subprocess.run(
            [sys.executable, "-c", _HASH_PROBE], capture_output=True,
            text=True, timeout=120, cwd=repo,
            env={**os.environ, "PYTHONHASHSEED": seed,
                 "JAX_PLATFORMS": "cpu"})
        assert r.returncode == 0, r.stderr
        rows.append(ast.literal_eval(r.stdout.strip().splitlines()[-1]))
    assert rows[0][0] == rows[1][0]
    assert rows[0][1] != rows[1][1]

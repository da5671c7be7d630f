"""Cross-process TrIMS in the port (``repro_torch.core.shm_ipc``): the
reference's four shm tests on the port's MRM server, bf16 bits over the
socket, a JAX-package client reading the same bytes from a port server, a
device-tier demotion into a segment, ``open_stream`` in shm mode, a segment
that survives its client's exit, and a killed client's handle released.

Sockets live under a short ``/tmp`` directory (AF_UNIX allows 107 bytes),
subprocess clients import the package from this checkout (found from
``__file__``), and every segment these tests create carries a prefix of
this process's own, so no other test's ``trims_*`` clean-up can unlink a
segment a running client still has to attach."""
import glob
import json
import os
import select
import shutil
import signal
import subprocess
import sys
import tempfile
import textwrap
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import shm_ipc
from repro_torch.core.mrm import MRM, ModelKey
from repro_torch.core.shm_ipc import MRMServer, RemoteTrimsClient
from repro_torch.core.store import BF16_BITS, DiskStore
from repro_torch.device import tensor_from_numpy

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
MB = 1 << 20
PREFIX = f"trimsport{os.getpid()}_"
SUBPROCESS_TIMEOUT_S = 60


def _tensors(nbytes=2 * MB, n=4, seed=0):
    rng = np.random.default_rng(seed)
    per = nbytes // n // 4
    return {f"w{i}": rng.standard_normal(per).astype(np.float32) for i in range(n)}


def _bf16(seed=3):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 1 << 16, size=(3, 64, 32), dtype=np.uint16)
    return {"embed": bits.view(BF16_BITS), "layers/w": bits[:, :8].copy().view(BF16_BITS),
            "scale": np.linspace(-1, 1, 32, dtype=np.float32)}


@pytest.fixture
def own_segments(monkeypatch):
    monkeypatch.setattr(shm_ipc, "SEGMENT_PREFIX", PREFIX)
    yield
    for path in glob.glob(f"/dev/shm/{PREFIX}*"):
        os.unlink(path)


def _bits(t):
    """A tensor's bit pattern (random bf16 bits hold NaNs, which never compare equal)."""
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t.view(torch.int32)


def _release(mrm):
    for e in list(mrm.host.entries.values()):
        if e.payload is not None:
            e.payload.release()


@pytest.fixture
def sockdir():
    d = tempfile.mkdtemp(prefix="tsh-", dir="/tmp")
    yield d
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture
def server(tmp_path, sockdir, own_segments):
    disk = DiskStore(str(tmp_path / "disk"))
    disk.put(ModelKey("jax", "shared"), _tensors(seed=7))
    disk.put(ModelKey("repro-torch", "bf16"), _bf16())
    mrm = MRM(disk, device_capacity=64 * MB, host_capacity=256 * MB, use_shm=True,
              device="cpu")
    srv = MRMServer(mrm, os.path.join(sockdir, "mrm.sock"))
    yield srv
    srv.stop()
    _release(mrm)


def test_same_process_client(server):
    client = RemoteTrimsClient(server.sock_path)
    h = client.open("jax", "shared")
    for k, v in _tensors(seed=7).items():
        np.testing.assert_array_equal(h.arrays[k], v)
    assert h.timings["tier_hit"] in ("disk", "host")
    h2 = client.open("jax", "shared")
    assert h2.timings["tier_hit"] == "host"
    assert h2.timings["total_s"] < h.timings["total_s"] + 1e-3
    client.close(h)
    client.close(h2)
    assert client.stats()["disk_loads"] == 1
    client.disconnect()


CLIENT_SCRIPT = textwrap.dedent("""
    import json, sys, time
    sys.path.insert(0, {src!r})
    import numpy as np
    from repro_torch.core.shm_ipc import RemoteTrimsClient

    c = RemoteTrimsClient({sock!r})
    t0 = time.perf_counter()
    h = c.open("jax", "shared")
    open_s = time.perf_counter() - t0
    checksum = float(sum(float(np.asarray(a, np.float64).sum()) for a in h.arrays.values()))
    segs = [s.name for s in h._segments]
    out = {{"checksum": checksum, "tier": h.timings["tier_hit"], "segments": segs,
           "open_s": open_s, "attach_s": h.attach_s, "nbytes": h.nbytes}}
    if {hold}:
        print(json.dumps(out), flush=True)
        time.sleep(120)
    c.close(h)
    c.disconnect()
    print(json.dumps(out))
""")


def _client(sock, hold=False):
    return [sys.executable, "-c", CLIENT_SCRIPT.format(src=SRC, sock=sock, hold=hold)]


def test_cross_process_sharing(server):
    """Two OS processes open the same model: one load, shared bytes; the
    daemon's segment outlives each client (an attaching process must not
    unlink it at exit)."""
    results = []
    for _ in range(2):
        out = subprocess.run(_client(server.sock_path), cwd=str(ROOT), capture_output=True,
                             text=True, timeout=SUBPROCESS_TIMEOUT_S)
        assert out.returncode == 0, out.stderr
        results.append(json.loads(out.stdout.strip().splitlines()[-1]))
        for name in results[-1]["segments"]:
            assert os.path.exists(f"/dev/shm/{name}"), "a client's exit unlinked the segment"
    want = float(sum(np.asarray(a, np.float64).sum() for a in _tensors(seed=7).values()))
    for r in results:
        assert abs(r["checksum"] - want) < 1e-3
    assert server.mrm.metrics["disk_loads"] == 1
    assert results[1]["tier"] == "host"
    assert server.mrm.host.peek(ModelKey("jax", "shared")).refcount == 0


def test_connection_death_releases_handles(server):
    client = RemoteTrimsClient(server.sock_path)
    client.open("jax", "shared")
    key = ModelKey("jax", "shared")
    assert server.mrm.host.peek(key).refcount == 1
    client.disconnect()
    for _ in range(100):
        if server.mrm.host.peek(key).refcount == 0:
            break
        time.sleep(0.05)
    assert server.mrm.host.peek(key).refcount == 0


def test_killed_client_is_released(server):
    """A client process killed with SIGKILL while it holds a handle: the
    daemon sees its connection die and drops the reference."""
    key = ModelKey("jax", "shared")
    proc = subprocess.Popen(_client(server.sock_path, hold=True), cwd=str(ROOT),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ready, _, _ = select.select([proc.stdout], [], [], SUBPROCESS_TIMEOUT_S)
        line = proc.stdout.readline() if ready else ""   # printed once A is held
        assert line, proc.stderr.read() if proc.poll() is not None else "no output"
        assert server.mrm.host.peek(key).refcount == 1
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=SUBPROCESS_TIMEOUT_S)
        deadline = time.monotonic() + 5
        while server.mrm.host.peek(key).refcount and time.monotonic() < deadline:
            time.sleep(0.05)
        assert server.mrm.host.peek(key).refcount == 0
        for name in json.loads(line)["segments"]:
            assert os.path.exists(f"/dev/shm/{name}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()
        proc.stderr.close()


def test_client_is_thread_safe(server):
    client = RemoteTrimsClient(server.sock_path)
    expect = _tensors(seed=7)
    errs = []

    def worker(i):
        try:
            for _ in range(15):
                h = client.open("jax", "shared")
                assert h.timings["tier_hit"] in ("disk", "host")
                np.testing.assert_array_equal(h.arrays["w0"], expect["w0"])
                assert isinstance(client.stats()["opens"], int)
                client.close(h)
        except Exception as e:  # noqa: BLE001 — collected for the assert
            errs.append((i, e))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errs, errs[:3]
    assert server.mrm.host.peek(ModelKey("jax", "shared")).refcount == 0
    client.disconnect()


def test_bf16_bits_over_the_socket(server):
    """The reply names bf16 as "bfloat16": the port's client gets tagged
    uint16 bits that the device put turns into torch.bfloat16, and the JAX
    package's client reads the same bits as ml_dtypes.bfloat16."""
    from repro.core.shm_ipc import RemoteTrimsClient as JaxClient
    want = _bf16()
    port, jax = RemoteTrimsClient(server.sock_path), JaxClient(server.sock_path)
    hp = port.open("repro-torch", "bf16")
    hj = jax.open("repro-torch", "bf16")
    for name, a in want.items():
        got = hp.arrays[name]
        assert got.dtype == a.dtype and got.dtype.metadata == a.dtype.metadata, name
        assert got.shape == a.shape and got.tobytes() == a.tobytes(), name
        assert hj.arrays[name].tobytes() == a.tobytes(), name
        assert hj.arrays[name].shape == a.shape, name
    assert hj.arrays["embed"].dtype.name == "bfloat16"
    t = tensor_from_numpy(hp.arrays["embed"], "cpu")
    assert t.dtype == torch.bfloat16
    assert t.view(torch.int16).numpy().view(np.uint16).tobytes() == want["embed"].tobytes()
    # the JAX client's float view and the port tensor agree as numbers
    np.testing.assert_array_equal(np.asarray(hj.arrays["embed"], np.float32),
                                  t.float().numpy())
    for c, h in ((port, hp), (jax, hj)):
        c.close(h)
        c.disconnect()


def test_jax_client_reads_the_port_server_like_the_port_client(server):
    from repro.core.shm_ipc import RemoteTrimsClient as JaxClient
    port, jax = RemoteTrimsClient(server.sock_path), JaxClient(server.sock_path)
    hp, hj = port.open("jax", "shared"), jax.open("jax", "shared")
    assert sorted(hp.arrays) == sorted(hj.arrays)
    for n in hp.arrays:
        assert hp.arrays[n].tobytes() == hj.arrays[n].tobytes(), n
        assert hp.arrays[n].dtype == hj.arrays[n].dtype, n
    assert (hp.nbytes, hj.timings["tier_hit"]) == (hj.nbytes, "host")
    assert jax.stats()["disk_loads"] == port.stats()["disk_loads"] == 1
    for c, h in ((port, hp), (jax, hj)):
        c.close(h)
        c.disconnect()
    assert server.mrm.host.peek(ModelKey("jax", "shared")).refcount == 0


def _sizes(disk, names):
    return {n: disk.open(ModelKey("t", n, "1")).total_bytes for n in names}


def test_device_demotion_lands_in_a_segment(tmp_path, own_segments):
    """shm mode: a device eviction copies each tensor straight into a new
    segment, which a client then attaches; its bytes equal the device copy's."""
    disk = DiskStore(str(tmp_path / "disk"))
    for i, n in enumerate("ABC"):
        disk.put(ModelKey("t", n, "1"), {**_bf16(seed=i), "x": _tensors(MB, 2, i)["w0"]})
    s = _sizes(disk, "ABC")
    mrm = MRM(disk, device_capacity=s["A"] + s["B"] // 2,
              host_capacity=s["A"] + s["B"] + s["B"] // 2, use_shm=True, device="cpu")
    key = lambda n: ModelKey("t", n, "1")  # noqa: E731
    try:
        mrm.close(mrm.open(key("A")))
        dev = {n: t.clone() for n, t in mrm.device.peek(key("A")).payload.items()}
        mrm.prefetch(key("B"), tier="host").result(timeout=60)
        mrm.prefetch(key("C"), tier="host").result(timeout=60)
        assert mrm.host.peek(key("A")) is None
        mrm.close(mrm.open(key("B")))                    # evicts A from the device
        assert mrm.tiers.demotions == 1
        hm = mrm.host.peek(key("A")).payload
        assert len(hm.shm_segments) == 1 and hm.shm_segments[0].name.startswith(PREFIX)
        for n, t in dev.items():
            got = hm.arrays[n]
            assert got.shape == tuple(t.shape) and got.dtype.metadata == \
                disk.open(key("A")).read_all()[n].dtype.metadata, n
            assert torch.equal(_bits(tensor_from_numpy(got, "cpu")), _bits(t)), n
        with tempfile.TemporaryDirectory(prefix="tsh-", dir="/tmp") as d:
            srv = MRMServer(mrm, os.path.join(d, "m.sock"))
            try:
                c = RemoteTrimsClient(srv.sock_path)
                h = c.open("t", "A")
                assert h.timings["tier_hit"] == "host"
                assert [s.name for s in h._segments] == [hm.shm_segments[0].name]
                for n, t in dev.items():
                    assert torch.equal(_bits(tensor_from_numpy(h.arrays[n], "cpu")), _bits(t)), n
                c.close(h)
                c.disconnect()
            finally:
                srv.stop()
        h = mrm.open(key("A"))
        assert h.timings.tier_hit == "host"
        assert mrm.stats()["demotion_saved_reloads"] >= 1
        mrm.close(h)
    finally:
        _release(mrm)


def test_open_stream_in_shm_mode_is_a_host_open(tmp_path, own_segments):
    disk = DiskStore(str(tmp_path / "disk"))
    disk.put(ModelKey("t", "A", "1"), _bf16())
    mrm = MRM(disk, device_capacity=64 * MB, host_capacity=64 * MB, use_shm=True,
              device="cpu")
    try:
        fut = mrm.open_stream(ModelKey("t", "A", "1"))
        h = fut.result(timeout=60)
        assert h.tier == "host" and h.timings.tier_hit == "disk"
        assert not fut.streaming and mrm.stats()["stream_loads"] == 0
        assert len(mrm.host.peek(ModelKey("t", "A", "1")).payload.shm_segments) == 1
        for n, a in _bf16().items():
            assert h.weights[n].tobytes() == a.tobytes(), n
        mrm.close(h)
    finally:
        _release(mrm)

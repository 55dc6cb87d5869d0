"""The reference's ``tests/test_cauchy.py``, run as written against the port
(``tests/test_torch_suites.py``)."""

import numpy as np
import pytest

from tests.test_torch_suites import check_replaced, load_port_suite

REPLACED: dict[str, str] = {
    "test_cauchy_encode_identity_numpy_xla_pallas":
        "calls the reference's XLA codec (cauchy.get_tpu_codec) and its Pallas kernel in "
        "interpret mode, which the port has not; the port's case holds its numpy codec, its "
        "torch codec (K3 on the card), K3's plain version and encode_kernel (the Pallas "
        "entry's counterpart) to the same bytes and digests",
    "test_obs_records_carry_family":
        "builds its dispatcher over the reference's XLA cauchy codec (cauchy.get_tpu_codec); "
        "the port's case is the same body over the port's cauchy.get_torch_codec",
}

load_port_suite("test_cauchy", globals(), REPLACED)


def test_replaced_cases_are_the_ports():
    check_replaced(globals(), REPLACED, __file__)


@pytest.mark.parametrize("d,p", [(4, 4), (8, 8)])
def test_cauchy_encode_identity_numpy_xla_pallas(d, p):
    """The port's cauchy encode routes agree bit for bit with its numpy
    codec: the torch codec (K3 on a card, its plain version on the CPU),
    K3's plain version called directly, ``encode_kernel`` (the reference's
    ``encode_blocks_pallas``), and the fused-style dispatch's parity and
    per-sub-chunk digests."""
    import torch

    from minio_tpu_torch.ops import rs_cuda
    from minio_tpu_torch.ops.highwayhash import hash256_batch_numpy

    rng = np.random.default_rng(1)
    per = 512
    blocks = rng.integers(0, 256, size=(4, d, per), dtype=np.uint8)
    ref = cauchy.get_codec(d, p)
    want = np.zeros((4, d + p, per), dtype=np.uint8)
    for i in range(4):
        want[i, :d] = blocks[i]
        ref.encode(want[i])
    codec = cauchy.get_torch_codec(d, p)
    got = codec.encode_blocks(blocks)
    assert np.array_equal(got.cpu().numpy(), want[:, d:])
    plain = rs_cuda.gf_apply_plain(codec.w_composite, codec.as_tensor(blocks), p,
                                   sub=cauchy.SUB_CHUNKS)
    assert torch.equal(plain, got)
    kern = cauchy.encode_kernel(ref, codec.as_tensor(blocks))
    assert np.array_equal(kern.cpu().numpy(), want[:, d:])
    par, digs = cauchy.encode_and_hash_cauchy(codec, blocks)
    assert np.array_equal(par.cpu().numpy(), want[:, d:])
    h = per // 2
    sub = want.reshape(4 * (d + p) * 2, h)
    assert np.array_equal(
        digs.cpu().numpy(), hash256_batch_numpy(sub).reshape(4, d + p, 2, 32)
    )


def test_obs_records_carry_family(monkeypatch):
    """tpu-type obs records gain a `family` field: the dispatcher's
    dispatch.batch record tags which code family the group served (the
    reference's case over the port's cauchy codec)."""
    from minio_tpu_torch import obs
    from minio_tpu_torch.ops import cauchy as cauchy_ops
    from minio_tpu_torch.parallel.dispatcher import get_dispatcher
    from minio_tpu_torch.server.metrics import TracePubSub

    monkeypatch.setenv("MINIO_TPU_BACKEND", "numpy")
    prev = obs.publisher()
    pub = TracePubSub()
    obs.set_publisher(pub)
    sub = pub.subscribe()
    try:
        codec = cauchy_ops.get_torch_codec(4, 2)
        disp = get_dispatcher(codec, 128)
        blocks = np.random.default_rng(3).integers(
            0, 256, size=(2, 4, 128), dtype=np.uint8
        )
        shards, digests = disp.encode(blocks, codec=codec)
        assert shards.shape == (2, 6, 128)
        assert digests.shape == (2, 6, 2, 32)
        import time as _time

        deadline = _time.monotonic() + 5.0
        fams = []
        while _time.monotonic() < deadline:
            rec = sub.q.get(timeout=5.0)
            if rec.get("name") == "dispatch.batch":
                fams.append(rec.get("family"))
                break
        assert fams == ["cauchy"], fams
    finally:
        pub.unsubscribe(sub)
        obs.set_publisher(prev)

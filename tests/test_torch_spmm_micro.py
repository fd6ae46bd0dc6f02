"""The port's micro-benchmark probe K6 (``ops/row_shuffle.py``) against
the reference's Pallas kernel, and the port's micro-benchmark tool
(``python -m sgcn_tpu_torch.tools.spmm_micro``) in-process on the CPU.

The reference defines its kernel, ``tga_kernel``, inside
``scripts/spmm_micro.py::main``, so it cannot be imported: the test
rebuilds the same ``pl.pallas_call`` body and runs it in interpret mode on
the CPU.  A row shuffle copies values and rounds nothing, so the port's
plain version must give the same bits.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from sgcn_tpu_torch.ops.row_shuffle import row_shuffle, row_shuffle_plain
from sgcn_tpu_torch.tools.spmm_micro import main as micro_main

S = 2048


def _tga(chunk, gidx):
    """``scripts/spmm_micro.py``'s probe body (its lines 157-166), in
    interpret mode: ``out = take_along_axis(x, broadcast(idx), axis=0)``."""
    s, f = chunk.shape

    def tga_kernel(idx_ref, x_ref, o_ref):
        ii = jnp.broadcast_to(idx_ref[:], (s, f))
        o_ref[:] = jnp.take_along_axis(x_ref[:], ii, axis=0)

    return np.asarray(pl.pallas_call(
        tga_kernel, out_shape=jax.ShapeDtypeStruct((s, f), jnp.float32),
        interpret=True)(jnp.asarray(gidx), jnp.asarray(chunk)))


@pytest.mark.parametrize("f", [1, 41, 128])
def test_row_shuffle_equals_the_pallas_probe(f):
    rng = np.random.default_rng(f)
    chunk = rng.standard_normal((S, f)).astype(np.float32)
    gidx = rng.integers(0, S, size=(S, 1)).astype(np.int32)
    want = _tga(chunk, gidx)
    x, idx = torch.from_numpy(chunk), torch.from_numpy(gidx)
    before = row_shuffle.launches
    got = row_shuffle(x, idx)
    assert row_shuffle.launches == before         # the CPU runs no kernel
    assert got.shape == (S, f) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, row_shuffle_plain(x, idx[:, 0]))


def test_row_shuffle_refuses_what_it_does_not_take():
    x = torch.zeros(8, 4)
    idx = torch.zeros(8, 1, dtype=torch.int32)
    with pytest.raises(TypeError, match="float32"):
        row_shuffle(x.double(), idx)
    with pytest.raises(TypeError, match="float32"):
        row_shuffle(x[None], idx)
    with pytest.raises(TypeError, match="int32"):
        row_shuffle(x, idx.long())
    with pytest.raises(TypeError, match="int32"):
        row_shuffle(x, torch.zeros(8, 2, dtype=torch.int32))
    with pytest.raises(IndexError):
        row_shuffle(x, torch.full((2,), 8, dtype=torch.int32))


def test_spmm_micro_runs_in_process_on_the_cpu(capsys):
    """The reference's probes in its order, then K6; each a positive time
    with its rate, and the JSON line last."""
    res = micro_main(["--device", "cpu", "--n", "2000", "--f", "16"])
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == json.loads(json.dumps(res))
    names = [p["name"] for p in res["spmm_micro"]]
    assert names == ["stream r+w", "ell take+reduce", "ell sorted idx",
                     "take+sum", "ell bf16 table", "dense (n,16)@(16,16)",
                     "matmul 4096^3 bf16", "row_shuffle S=2048"]
    assert len(out) == len(names) + 1
    for p in res["spmm_micro"]:
        rate = p.get("gbps", p.get("tflops"))
        assert p["ms"] > 0 and np.isfinite(rate) and rate > 0, p
    assert res["device"] == "cpu" and res["timer"] == "host clock"
    assert (res["n"], res["f"], res["ellk"], res["s"]) == (2000, 16, 24, S)


def test_spmm_micro_without_cpu_raises_when_no_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        micro_main(["--n", "2000", "--f", "16"])

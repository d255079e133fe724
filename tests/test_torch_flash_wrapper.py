"""The flash-attention wrapper's checks and counts on the CPU
(``repro_torch/kernels/flash_attention/ops.py``).

The tensor-core kernel loads q, k and v through TMA tensor maps, which
need each tensor to start on a 16-byte boundary; the wrapper checks that
on both devices, as it checks dtype, layout and shape, so a CPU caller
meets the same rule as a CUDA one.  A CPU call runs the plain version
and launches nothing, so it leaves the launch counts as they were.
"""
import pytest
import torch

from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def shifted(shape, dtype, offset):
    """A contiguous tensor of ``shape`` that starts ``offset`` elements
    into its storage."""
    n = 1
    for d in shape:
        n *= d
    return torch.zeros(n + offset, dtype=dtype)[offset:].view(shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_wrapper_rejects_a_misaligned_start(dtype, which):
    args = {"q": shifted((1, 8, 4, 64), dtype, 0),
            "k": shifted((1, 8, 2, 64), dtype, 0),
            "v": shifted((1, 8, 2, 64), dtype, 0)}
    args[which] = shifted(tuple(args[which].shape), dtype, 1)
    assert args[which].is_contiguous() and args[which].data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte boundary"):
        ops.flash_attention(args["q"], args["k"], args["v"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_takes_an_aligned_view(dtype):
    """A view that starts a multiple of 16 bytes in is taken, and gives
    the plain version's output."""
    offset = 16 * 8 // torch.finfo(dtype).bits     # 16 bytes
    q = shifted((1, 8, 4, 64), dtype, offset)
    q.copy_(torch.randn(q.shape))
    k = torch.randn(1, 8, 2, 64).to(dtype)
    got = ops.flash_attention(q, k, k)
    assert torch.equal(got, flash_attention_ref(q.clone(), k, k))


def test_cpu_calls_launch_nothing():
    q, k = torch.randn(1, 8, 4, 64), torch.randn(1, 8, 2, 64)
    before = (ops.launches, dict(ops.path_launches))
    ops.flash_attention(q, k, k)
    ops.flash_attention(q.bfloat16(), k.bfloat16(), k.bfloat16())
    assert (ops.launches, ops.path_launches) == before
    assert set(ops.path_launches) == set(ops.PATHS)

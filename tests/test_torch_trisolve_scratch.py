"""The triangular solve's scratch sizing (CPU; the kernel runs on the card).

The sweep kernel in gpnf_tpu_torch/csrc/tril_solve.cu waits on ready flags
in a scratch that the wrapper zeroes; these tests pin that the scratch
holds every flag the kernel reads."""
import pytest

from gpnf_tpu_torch.ops.kernels.trisolve import tril_solve_scratch_words


@pytest.mark.parametrize("n,p", [(1, 1), (63, 31), (64, 32), (65, 33),
                                 (1000, 300), (4096, 4096)])
def test_tril_solve_scratch_holds_every_flag_the_sweep_reads(n, p):
    """The sweep kernel (csrc/tril_solve.cu) reads word 0 (the ticket
    counter) and the flag 1 + i * ct + c of every 64-row block i and
    column tile c (4 wide below p = 32, else 64); a flag beyond the
    zeroed scratch would be read uninitialised."""
    tp = 4 if p < 32 else 64
    nb, ct = -(-n // 64), -(-p // tp)
    last_flag = 1 + (nb - 1) * ct + (ct - 1)
    assert tril_solve_scratch_words(n, p) == last_flag + 1


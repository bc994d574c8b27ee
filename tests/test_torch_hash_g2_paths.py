"""``hash_to_g2_batch``'s device XMD paths on the CPU against RFC 9380
J.10.1 and the port's host hasher (tolerance: zero): the block path ("" and
"abc", each a uniform batch) and the word path (a uniform batch of 16-byte
messages, a multiple of 4).  The host path and the map's parts are held by
``tests/test_torch_hash_g2.py``."""

import pytest
import torch

from mathlib_tpu_torch import get_spec
from mathlib_tpu_torch.host.hash_to_curve import get_hasher
from mathlib_tpu_torch.ops import hash as H
from test_hash_vectors import DST_G2, G2_VECTORS, MSGS

torch.set_num_threads(1)

SPEC = get_spec("BLS12_381")


def _hash(msgs):
    out = H.hash_to_g2_batch(SPEC, msgs, DST_G2, device="cpu")
    return H.get_hash_g2_ctx(SPEC, "cpu").g2.decode_points(out)


@pytest.mark.parametrize("i", [0, 1])
def test_block_path_gives_the_rfc_vectors(i):
    assert len(MSGS[i]) % 4 or not MSGS[i]  # the block path
    got = _hash([MSGS[i]] * 2)
    assert [(tuple(x), tuple(y)) for x, y in got] == [G2_VECTORS[i]] * 2


def test_word_path_gives_the_rfc_vector_and_the_host_hasher():
    msgs = [MSGS[2], bytes(range(16)), b"0123456789abcdef"]
    assert {len(m) for m in msgs} == {16}  # the word path
    got = _hash(msgs)
    assert (tuple(got[0][0]), tuple(got[0][1])) == G2_VECTORS[2]
    hasher = get_hasher(SPEC)
    assert got == [hasher.hash_to_g2(m, DST_G2) for m in msgs]

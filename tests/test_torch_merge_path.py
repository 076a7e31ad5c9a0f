"""Host-side launch arithmetic of the port's merge-path kernels (K1,
csrc/segscan.cu, and K3, csrc/gather_reduce.cu, over csrc/merge_path.cuh).

The wrappers size the carry-out scratch from ``merge_path_shares`` (one row
per share of the N + S step merge path); here it is held against a
brute-force count of the shares the steps fall in.  The kernels themselves
run only on the card (tests/test_torch_cuda.py).
"""

import pytest

from subgraph_sketching_tpu_torch.ops import cuda_build


# (num_rows, num_items, steps): one row, empty paths, a path of exactly one
# share and one share +- 1, the main path's K1 shape, K3's padded edge
# list with one row, and a long last row
@pytest.mark.parametrize("num_rows,num_items,steps", [
    (1, 0, 64), (0, 0, 64), (64, 0, 64), (63, 1, 64), (65, 0, 64),
    (1, 62, 64), (200_000, 234_611, 64), (2, 4096, 256), (7, 3 * 256 + 5, 256),
])
def test_merge_path_shares_is_a_brute_force_count(num_rows, num_items, steps):
    brute = len({d // steps for d in range(num_rows + num_items)})
    assert cuda_build.merge_path_shares(num_rows, num_items, steps) == brute


def test_library_name_follows_the_shared_header(tmp_path, monkeypatch):
    """An edit of csrc/merge_path.cuh rebuilds both kernels' libraries."""
    (tmp_path / "k.cu").write_text("kernel")
    (tmp_path / "merge_path.cuh").write_text("header")
    monkeypatch.setattr(cuda_build, "CSRC", str(tmp_path))
    first = cuda_build.library_path("k")
    assert cuda_build.library_path("k") == first
    (tmp_path / "merge_path.cuh").write_text("header, edited")
    assert cuda_build.library_path("k") != first

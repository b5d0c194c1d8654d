"""famsa_tpu_torch's guide-tree methods and distance export against the
famsa_tpu package.

Every flag set runs through the port's CLI entry point with -backend torch
-device cpu (distance rows from K1's plain PyTorch versions) and with
-backend numpy, and through famsa_tpu's with -backend numpy, on one
~200-sequence scripts/make_family.py family.  The heuristic runs use small
medoid parameters (every distance set of FastTree takes K1 on -backend
torch), and once the default subtree size with a sample whose CLARANS
neighbour count leaves its floor of 250; one MedoidTree run is also held
against famsa_tpu -backend jax with its device route forced for every
distance set.  Tolerance: exact (byte-identical trees, CSVs and
alignments).
"""

import ctypes
import pathlib
import subprocess
import sys

import pytest

from famsa_tpu.cli import main as j_main
from famsa_tpu_torch.cli import main as t_main
from famsa_tpu_torch.native import get_lib

REPO = pathlib.Path(__file__).resolve().parent.parent
MEDOID = ["-medoid_threshold", "50", "-subtree_size", "20",
          "-sample_size", "100"]
# the default subtree size (100); a sample of 150 gives CLARANS
# (150 - 100) * 100 swaps, so 500 neighbours, above the floor of 250
MEDOID_DEFAULT_SUBTREE = ["-medoid_threshold", "150", "-sample_size", "150"]


@pytest.fixture(scope="module")
def family(tmp_path_factory):
    path = tmp_path_factory.mktemp("trees") / "fam.fa"
    subprocess.run([sys.executable, str(REPO / "scripts" / "make_family.py"),
                    "200", "60", str(path), "3"],
                   check=True, capture_output=True)
    return path


def _out(main, args, fa, out):
    assert main(args + [str(fa), str(out)]) == 0
    return out.read_bytes()


# the alignments run without refinement: the tree is what differs here,
# and refinement's route is held by tests/test_torch_pipeline.py
ALIGN = ["-refine_mode", "off"]
FLAGS = {
    **{f"{gt}{'_export' if ex else ''}": ["-gt", gt] + (["-gt_export"]
                                                       if ex else ALIGN)
       for gt in ("slink", "upgma", "upgma_modified", "nj")
       for ex in (True, False)},
    "dist_export": ["-dist_export"],
    "dist_export_pid": ["-dist_export", "-pid"],
    "dist_export_square": ["-dist_export", "-square_matrix"],
    "medoidtree_export": ["-medoidtree"] + MEDOID + ["-gt_export"],
    "parttree_export": ["-parttree"] + MEDOID + ["-gt_export"],
    "medoidtree": ["-medoidtree"] + MEDOID + ALIGN,
    "medoidtree_default_subtree_export": (["-medoidtree"]
                                          + MEDOID_DEFAULT_SUBTREE
                                          + ["-gt_export"]),
    "parttree_default_subtree_export": (["-parttree"]
                                        + MEDOID_DEFAULT_SUBTREE
                                        + ["-gt_export"]),
}


@pytest.mark.parametrize("name", list(FLAGS))
def test_flags_match_famsa_tpu_numpy(name, family, tmp_path):
    """The port's torch (CPU) and numpy backends give famsa_tpu -backend
    numpy's bytes; no flag set is refused."""
    flags = FLAGS[name]
    want = _out(j_main, ["-backend", "numpy"] + flags, family,
                tmp_path / "want")
    assert want
    got_np = _out(t_main, ["-backend", "numpy"] + flags, family,
                  tmp_path / "np")
    got_t = _out(t_main, ["-backend", "torch", "-device", "cpu"] + flags,
                 family, tmp_path / "torch")
    assert got_np == want
    assert got_t == want


def test_medoidtree_matches_famsa_tpu_jax(family, tmp_path, monkeypatch):
    """MedoidTree's device distances (first row, assignment pass, CLARANS
    sample matrix, subgroup SLINK rows) against famsa_tpu's device route
    (jax on the CPU), forced below its size gate; the depth-0 seeds
    (-dump_seeds) agree too."""
    monkeypatch.setenv("FAMSA_TPU_FASTTREE_DEV_MIN", "1")
    flags = ["-medoidtree"] + MEDOID + ["-gt_export"]
    want = _out(j_main, ["-backend", "jax", "-dump_seeds",
                         str(tmp_path / "seeds_want")] + flags, family,
                tmp_path / "want")
    got = _out(t_main, ["-backend", "torch", "-device", "cpu", "-dump_seeds",
                        str(tmp_path / "seeds_got")] + flags, family,
               tmp_path / "got")
    assert got == want
    seeds = (tmp_path / "seeds_got").read_text()
    assert len(seeds.splitlines()) == 20
    assert seeds == (tmp_path / "seeds_want").read_text()


def test_native_loader_declares_tree_entries():
    """SLINK's and CLARANS's native entries carry famsa_tpu's argtypes, and
    the two that return a cost return a C float (without the declarations
    ctypes would pass the arrays and read the float wrongly, silently)."""
    from famsa_tpu.native import get_lib as j_get_lib
    lib, jlib = get_lib(), j_get_lib()
    assert jlib is not None
    for entry in ("slink_update_row", "clarans_init", "clarans_deltas",
                  "clarans_apply_swap"):
        fn, jfn = getattr(lib, entry), getattr(jlib, entry)
        assert fn.argtypes is not None, entry
        assert list(fn.argtypes) == list(jfn.argtypes), entry
        assert fn.restype == jfn.restype, entry
    assert lib.clarans_init.restype is ctypes.c_float
    assert lib.clarans_apply_swap.restype is ctypes.c_float

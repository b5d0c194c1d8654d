"""famsa_tpu_torch end to end against the famsa_tpu package.

The port's pipeline with backend torch on the CPU (the kernels' plain
PyTorch versions) and FAMSA_TORCH_DP_MIN_CELLS=0 (every profile merge and
guided re-alignment on the device DP route) against famsa_tpu's
compute_msa with backend numpy, in process and through both CLIs.
Tolerance: exact (byte-identical alignments and trees).
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from famsa_tpu.core.params import Params as JParams
from famsa_tpu.core.sequence import Sequence as JSequence
from famsa_tpu.pipeline import align_profiles as j_align_profiles
from famsa_tpu.pipeline import compute_msa as j_compute_msa
from famsa_tpu_torch.cli import main as t_main
from famsa_tpu_torch.core.aligner import device_dp_ok, split_ready
from famsa_tpu_torch.core.params import Params as TParams
from famsa_tpu_torch.core.sequence import Sequence as TSequence
from famsa_tpu_torch.interop import params_from_fields
from famsa_tpu_torch.pipeline import align_profiles as t_align_profiles
from famsa_tpu_torch.pipeline import compute_msa as t_compute_msa

REPO = pathlib.Path(__file__).resolve().parent.parent
AA = "ARNDCQEGHILKMFPSTWYV"


def _random_strings(seed, n, lmin, lmax):
    rng = np.random.default_rng(seed)
    return ["".join(AA[rng.integers(0, 20)]
                    for _ in range(int(rng.integers(lmin, lmax))))
            for _ in range(n)]


def _family_strings(seed, n, length):
    rng = np.random.default_rng(seed)
    out = [rng.integers(0, 20, size=length)]
    while len(out) < n:
        child = out[rng.integers(0, len(out))].copy()
        k = max(1, int(len(child) * rng.uniform(0.05, 0.2)))
        pos = rng.integers(0, len(child), size=k)
        child[pos] = rng.integers(0, 20, size=k)
        if rng.random() < 0.5:
            p = int(rng.integers(0, len(child) - 5))
            if rng.random() < 0.5:
                child = np.delete(child, slice(p, p + 4))
            else:
                child = np.insert(child, p, rng.integers(0, 20, size=3))
        out.append(child)
    return ["".join(AA[c] for c in s) for s in out]


def _run_jax(strings):
    params = JParams()
    params.backend = "numpy"
    res = j_compute_msa(params, [JSequence(f">s{k}", s, k)
                                 for k, s in enumerate(strings)])
    return [gs.decode() for gs in res.alignment]


def _run_port(strings):
    params = TParams(backend="torch", device="cpu")
    res = t_compute_msa(params, [TSequence(f">s{k}", s, k)
                                 for k, s in enumerate(strings)])
    return [gs.decode() for gs in res.alignment]


@pytest.mark.parametrize("kind", ["random12", "family30",
                                  "family30_min_cells_4000"])
def test_compute_msa_matches_numpy(kind, monkeypatch):
    """min_cells 4000 splits the 30-sequence family's merges (widths
    ~60-70) between the device DP route and the native host DP."""
    monkeypatch.setenv("FAMSA_TORCH_DP_MIN_CELLS",
                       "4000" if kind.endswith("4000") else "0")
    strings = (_random_strings(33, 12, 25, 45) if kind == "random12"
               else _family_strings(5, 30, 60))
    assert _run_port(strings) == _run_jax(strings)


def test_align_profiles_matches_numpy(monkeypatch):
    """Profile-profile mode on two halves of an alignment."""
    monkeypatch.setenv("FAMSA_TORCH_DP_MIN_CELLS", "0")
    rows = _run_jax(_family_strings(9, 10, 40))
    recs1 = [(f">a{k}", r) for k, r in enumerate(rows[:4])]
    recs2 = [(f">b{k}", r) for k, r in enumerate(rows[4:])]
    jp = JParams()
    jp.backend = "numpy"
    jp.adjust(len(rows))
    tp = TParams(backend="torch", device="cpu")
    tp.adjust(len(rows))
    want = [gs.decode() for gs in j_align_profiles(jp, recs1, recs2)]
    got = [gs.decode() for gs in t_align_profiles(tp, recs1, recs2)]
    assert got == want


def _write_family(path, n, mean_len, seed):
    subprocess.run([sys.executable, str(REPO / "scripts" / "make_family.py"),
                    str(n), str(mean_len), str(path), str(seed)],
                   check=True, capture_output=True)


def _cli(module, args, env=None):
    proc = subprocess.run([sys.executable, "-m", module] + args, cwd=REPO,
                          capture_output=True, text=True,
                          env={**os.environ, **(env or {})})
    assert proc.returncode == 0, proc.stderr
    return proc


@pytest.mark.parametrize("export_tree", [False, True])
def test_cli_matches_famsa_tpu_numpy(tmp_path, export_tree):
    fa = tmp_path / "fam.fa"
    _write_family(fa, 60, 70, 4)
    flags = ["-gt_export"] if export_tree else []
    want, got = tmp_path / "want.out", tmp_path / "got.out"
    _cli("famsa_tpu", ["-backend", "numpy"] + flags + [str(fa), str(want)])
    _cli("famsa_tpu_torch", ["-backend", "torch", "-device", "cpu"] + flags
         + [str(fa), str(got)], env={"FAMSA_TORCH_DP_MIN_CELLS": "0"})
    assert got.read_bytes() == want.read_bytes()


@pytest.mark.parametrize("knob", ["FAMSA_TORCH_FAST_CONSTRUCT",
                                  "FAMSA_TORCH_DEFER_GAPS"])
def test_cli_knob_off_matches_famsa_tpu_numpy(tmp_path, knob):
    """The copied host routes a knob set to 0 selects: the reference
    construct (core/construct.py) and member gaps applied in place."""
    fa = tmp_path / "fam.fa"
    _write_family(fa, 60, 70, 4)
    want, got = tmp_path / "want.out", tmp_path / "got.out"
    _cli("famsa_tpu", ["-backend", "numpy", str(fa), str(want)])
    _cli("famsa_tpu_torch", ["-backend", "torch", "-device", "cpu",
                             str(fa), str(got)],
         env={knob: "0", "FAMSA_TORCH_DP_MIN_CELLS": "0"})
    assert got.read_bytes() == want.read_bytes()


def _stub(width, n_seqs):
    return SimpleNamespace(width=width, data=range(n_seqs),
                           counters=np.ones((width + 1, 32), np.int64))


def test_split_ready_routes_by_cells(monkeypatch):
    """A ready profile merge goes to the device DP from
    FAMSA_TORCH_DP_MIN_CELLS cells, however many are ready with it, and
    in align_into's operand order; the host keeps the given order."""
    monkeypatch.setenv("FAMSA_TORCH_DP_MIN_CELLS", "200")
    seq = _stub(10, 1)
    ready = [("a", _stub(10, 2), _stub(15, 3)),      # 150 cells
             ("b", _stub(25, 3), seq),               # 250, seq-prof
             ("c", _stub(20, 2), _stub(20, 3))]      # 400
    device, host = split_ready(ready)
    assert [k for k, _, _ in device] == ["b", "c"]
    assert device[0][1] is seq                       # the sequence first
    assert host == [ready[0]]
    assert device_dp_ok(_stub(10, 2), _stub(20, 3))
    assert not device_dp_ok(_stub(10, 2), _stub(19, 3))


def test_port_imports_no_jax(tmp_path):
    """The port runs an alignment without importing jax or famsa_tpu."""
    code = (
        "import json, sys\n"
        "from famsa_tpu_torch.core.params import Params\n"
        "from famsa_tpu_torch.core.sequence import Sequence\n"
        "from famsa_tpu_torch.pipeline import compute_msa\n"
        "p = Params(backend='torch', device='cpu')\n"
        "seqs = [Sequence(f'>s{k}', s, k) for k, s in enumerate(\n"
        "    ['ARNDCQEGHILK', 'ARNDQEGHILKM', 'RNDCQEGHIL', 'ARNDCQGHILKMF'])]\n"
        "res = compute_msa(p, seqs)\n"
        "assert len(res.alignment) == 4\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'famsa_tpu' or m.startswith('famsa_tpu.')]\n"
        "print(json.dumps(bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_backend_auto_without_cuda_raises(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TParams(backend="auto").resolve_backend()
    p = TParams(backend="auto", device="cpu")
    assert p.resolve_backend() == "torch"
    fa = tmp_path / "in.fa"
    fa.write_text(">a\nARNDCQ\n>b\nARNDQ\n>c\nRNDCQE\n")
    assert t_main(["-backend", "auto", str(fa), str(tmp_path / "o")]) == -1
    assert "CUDA" in capsys.readouterr().err
    assert t_main(["-device", "gpu", str(fa), str(tmp_path / "o")]) == -1
    assert t_main(["-backend", "jax", str(fa), str(tmp_path / "o")]) == -1


def test_params_from_fields():
    jp = JParams(gap_open_base=12.0)
    jp.guided_alignment_radius = 7
    jp.adjust(300)                   # rescaled gap costs, score matrix
    tp = params_from_fields(dataclasses.asdict(jp))
    for f in ("gap_open", "gap_ext", "gap_term_open", "gap_term_ext",
              "guided_alignment_radius", "n_refinements", "gt_method",
              "distance", "refinement_mode"):
        assert getattr(tp, f) == getattr(jp, f), f
    assert np.array_equal(tp.score_matrix, jp.score_matrix)
    assert tp.medoid.sample_size == jp.medoid.sample_size


def _gapped_profile(module, rows):
    """An aligned profile of `rows` in famsa_tpu's or the port's classes
    (module: "famsa_tpu" or "famsa_tpu_torch")."""
    import importlib
    prof_mod = importlib.import_module(f"{module}.core.profile")
    seq_mod = importlib.import_module(f"{module}.core.sequence")
    params_mod = importlib.import_module(f"{module}.core.params")
    params = params_mod.Params()
    params.backend = "numpy"
    params.adjust(len(rows))
    prof = prof_mod.Profile(params)
    for k, row in enumerate(rows):
        prof.append_raw_sequence(seq_mod.encode_gapped(f">s{k}", row, k))
    prof.calculate_counters_scores()
    return prof


@pytest.mark.parametrize("seed", [3, 4, 5, 6])
def test_refinement_splits_match_famsa_tpu(seed):
    """The refinement's split choices: the port's _split_columns (one
    numpy pass a profile) and famsa_tpu's loop over every column give the
    same dest_prof_id for the same mt19937 draws, on an alignment with
    one long sequence (most columns gapped in all rows but one, the case
    that made the loop slow) and on one where columns tie on x."""
    from famsa_tpu.core import refinement as jr
    from famsa_tpu.utils.mt19937 import MT19937 as JMT
    from famsa_tpu_torch.core import refinement as tr
    from famsa_tpu_torch.utils.mt19937 import MT19937 as TMT
    strings = _family_strings(seed, 8, 40)
    if seed % 2:
        strings.append(_random_strings(seed, 1, 400, 401)[0])
    rows = _run_jax(strings)
    jp, tp = (_gapped_profile(m, rows)
              for m in ("famsa_tpu", "famsa_tpu_torch"))
    jrnd, trnd = JMT(5489), TMT(5489)
    columns = tr._split_columns(tp)
    gap_stats = None
    for i in range(200):
        want, gap_stats = jr._refine_most_empty_and_full_column(
            jrnd, jp, gap_stats, i > 0)
        assert tr._refine_most_empty_and_full_column(trnd, tp,
                                                     columns) == want


def _gapped_rows(seed, n, width, p_gap):
    """n random rows of `width` columns with gap runs of geometric
    lengths (terminal runs among them); every row keeps a residue."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        row = np.array(list(AA))[rng.integers(0, 20, size=width)]
        gap = np.zeros(width, dtype=bool)
        i = 0
        while i < width:
            if rng.random() < p_gap:
                run = int(rng.geometric(0.3))
                gap[i:i + run] = True
                i += run + 1
            else:
                i += 1
        gap[int(rng.integers(0, width))] = False
        row[gap] = "-"
        out.append("".join(row))
    return out


@pytest.mark.parametrize("n,width,p_gap", [
    (1000, 120, 0.05), (60, 900, 0.03), (17, 3000, 0.01), (6, 4, 0.6),
    (3, 2, 0.5), (40, 50, 0.3)])
def test_total_score_matches_famsa_tpu(n, width, p_gap):
    """calculate_total_score's exact gap-open count from the runs within
    each window of columns (_runs_within, a merge-sort tree) against
    famsa_tpu's (width + 1)^2 gap_ranges table: the same score, on
    profiles with many nested, repeated and terminal gap runs."""
    rows = _gapped_rows(n + width, n, width, p_gap)
    want, got = (_gapped_profile(m, rows).calculate_total_score()
                 for m in ("famsa_tpu", "famsa_tpu_torch"))
    assert got == want

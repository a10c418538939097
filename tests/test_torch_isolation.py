"""The port stands alone: no JAX, nothing of the reference package.

A fresh interpreter imports every module of ``repro_torch`` and must end
with neither ``jax``, ``jaxlib`` nor ``repro`` in ``sys.modules``; the
same holds for the import statements of ``chip_smoke.py``.  Entry points
run on the card unless the caller asks for the CPU, and raise — never fall
back — when no card is there.
"""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_every_module_imports_without_jax_or_reference():
    mods = list(_modules())
    assert "repro_torch.streams.vision_engine" in mods
    assert "repro_torch.serving.engine" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print(len(bad)); print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[0] == "0", out.stdout


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_source_file_names_jax_or_reference_in_an_import():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for path in files:
        assert not _imported_roots(path) & set(FORBIDDEN), path


def test_entry_points_raise_without_a_card(monkeypatch):
    from repro_torch.config import get_arch
    from repro_torch.device import resolve_device
    from repro_torch.models import attention as TA
    from repro_torch.models import transformer as TT
    from repro_torch.serving import ServeEngine
    from repro_torch.streams import MotionGate, VisionServeEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VisionServeEngine("e", slots=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MotionGate(1)
    cfg = get_arch("starcoder2-3b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.init_params(cfg, torch.Generator().manual_seed(0))
    params = TT.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(cfg, params)
    for init in (TT.init_caches, TT.init_paged_caches, TA.init_cache,
                 TA.init_paged_cache):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init(cfg, 2, 16)
        assert init(cfg, 2, 16, device="cpu")
    assert ServeEngine(cfg, params, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    eng = VisionServeEngine("e", slots=1, frame_res=32, input_res=16,
                            device="cpu")
    assert eng.batches["outer"].device.type == "cpu"
    from repro_torch.simulate import get_scenario, run_scenario
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_scenario(get_scenario("golden_churn", ticks=1))
    assert run_scenario(get_scenario("golden_churn", ticks=1),
                        device="cpu").ok


def test_recurrent_entry_points_default_to_the_card(monkeypatch):
    """The recurrent and hybrid constructors raise without a card unless
    asked for the CPU; the RG-LRU and mLSTM wrappers take CPU tensors
    without being asked (their plain versions) and launch nothing."""
    from repro_torch.config import get_arch
    from repro_torch.kernels import mlstm as mlstm_k
    from repro_torch.kernels import rglru as rglru_k
    from repro_torch.models import rglru as TR
    from repro_torch.models import ssm as TS
    from repro_torch.models import transformer as TT
    from repro_torch.serving import ServeEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ("recurrentgemma-9b", "xlstm-350m"):
        cfg = get_arch(arch).reduced()
        for init in (lambda **kw: TT.init_caches(cfg, 2, 16, **kw),
                     lambda **kw: TT.init_params(
                         cfg, torch.Generator().manual_seed(0), **kw),
                     lambda **kw: TR.init_rglru_cache(cfg, 2, **kw),
                     lambda **kw: TS.init_mlstm_state(cfg, 2, **kw),
                     lambda **kw: TS.init_slstm_state(cfg, 2, **kw)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                init()
            assert init(device="cpu")
        params = TT.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServeEngine(cfg, params)
        eng = ServeEngine(cfg, params, device="cpu")
        assert eng.device.type == "cpu" and not eng.paged
        assert all(t.device.type == "cpu" for layer in eng.caches
                   for t in layer.values())
    rglru_k.reset_launches()
    mlstm_k.reset_launches()
    a = torch.rand(1, 5, 8)
    assert rglru_k.rglru_scan(a, a, a[:, 0]).device.type == "cpu"
    q = torch.rand(1, 5, 2, 8)
    g = torch.rand(1, 5, 2)
    assert mlstm_k.mlstm_chunkwise(q, q, q, g, g).device.type == "cpu"
    assert rglru_k.LAUNCHES == {"rglru_scan": 0}
    assert mlstm_k.LAUNCHES == {"mlstm_chunkwise": 0}


def test_encdec_and_vlm_entry_points_default_to_the_card(monkeypatch):
    """whisper-base's and internvl2-2b's constructors (``init_params``,
    ``init_caches`` with the cross K/V leaves, ``init_paged_caches``,
    ``ServeEngine``) raise without a card unless asked for the CPU; the
    encoder and the patch path (``encode``, ``forward``/``prefill`` with
    frames or patches) run where their inputs lie and launch nothing on
    CPU tensors."""
    from repro_torch.config import get_arch
    from repro_torch.kernels import ops as kops
    from repro_torch.models import transformer as TT
    from repro_torch.models.attention import RunOpts
    from repro_torch.serving import ServeEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch, extra in (("whisper-base", "frames"),
                        ("internvl2-2b", "patches")):
        cfg = get_arch(arch).reduced()
        inits = [lambda **kw: TT.init_caches(cfg, 2, 16, **kw),
                 lambda **kw: TT.init_params(
                     cfg, torch.Generator().manual_seed(0), **kw)]
        if TT.paged_eligible(cfg):
            inits.append(lambda **kw: TT.init_paged_caches(cfg, 4, 4, **kw))
        for init in inits:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                init()
            assert init(device="cpu")
        caches = TT.init_caches(cfg, 2, 16, device="cpu")
        cross = [c["cross_k"] for c in caches if "cross_k" in c]
        assert len(cross) == (cfg.num_layers if arch == "whisper-base" else 0)
        assert all(t.device.type == "cpu" and not t.any() for t in cross)
        params = TT.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServeEngine(cfg, params)
        eng = ServeEngine(cfg, params, device="cpu")
        assert eng.paged == (arch == "internvl2-2b")
        n = cfg.encoder_seq if extra == "frames" else cfg.num_patches
        extras = {extra: torch.rand(2, n, cfg.d_model)}
        opts = RunOpts(use_kernels=True)
        kops.reset_launches()
        if extra == "frames":
            assert TT.encode(cfg, params, extras[extra],
                             opts=opts).device.type == "cpu"
        logits, caches = TT.prefill(cfg, params,
                                    torch.zeros(2, 6, dtype=torch.long),
                                    extras=extras, opts=opts)
        assert logits.device.type == "cpu"
        assert all(t.device.type == "cpu" for c in caches
                   for t in c.values())
        assert not any(kops.launches().values())


def test_chip_smoke_refuses_without_card_or_checkout(tmp_path):
    """No CUDA here: non-zero exit and no result line.  Alone in a
    directory: the same."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", lone):
        out = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_library_key_follows_the_headers_a_source_includes(tmp_path,
                                                           monkeypatch):
    """A kernel library is rebuilt when its source or a csrc/ header that
    the source includes changes, and only then: an edit of the attention
    helpers changes the keys of the four libraries that include them (both
    attention libraries, the recurrent one and the vision one), an edit of
    a header that no source includes changes none."""
    from repro_torch.kernels import build
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in build.CSRC.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", csrc)
    names = sorted(f.stem for f in csrc.glob("*.cu"))
    before = {n: build.source_key(n) for n in names}
    assert before == {n: build.source_key(n) for n in names}
    header = csrc / "attention_helpers.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: build.source_key(n) for n in names}
    changed = {n for n in names if after[n] != before[n]}
    assert changed == {"attention", "decode_attention", "recurrent",
                       "vision_ops"}
    unused = csrc / "unused_helpers.cuh"
    unused.write_text("#pragma once\n")
    before = after
    unused.write_text("#pragma once\n// edited\n")
    assert {n: build.source_key(n) for n in names} == before

"""Checks of the PyTorch port's train step that need no JAX reference:
the checkpointed decode steps recompute the same random numbers, the step
goes through the kernel wrappers as often as chip_smoke.py expects
launches, and recognize runs in eval mode after training.  Tiny dims, CPU,
dropout on, so the kernels' plain versions run."""
import dataclasses

import numpy as np
import torch

from sbl_for_multilingual_lip_reading_tpu_torch import config as port_config
from sbl_for_multilingual_lip_reading_tpu_torch.data import make_train_plans
from sbl_for_multilingual_lip_reading_tpu_torch.models import build_model
from sbl_for_multilingual_lip_reading_tpu_torch.models import frontend, layers
from sbl_for_multilingual_lip_reading_tpu_torch.ops import attention
from sbl_for_multilingual_lip_reading_tpu_torch.recognize import recognize_batch
from sbl_for_multilingual_lip_reading_tpu_torch.training.schedule import (
    make_optimizer)
from sbl_for_multilingual_lip_reading_tpu_torch.training.steps import (
    expected_launches, make_sbl_train_step)


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _step_grads(cfg, seed=0, model=None):
    if model is None:
        model = build_model(cfg, "cpu", seed=seed)
    step = make_sbl_train_step(model, make_optimizer(model, cfg.optim), cfg)
    rng = np.random.default_rng(4)
    T, raw = cfg.data.frames, cfg.data.raw_size
    B = 2
    offsets, flip, fmap = make_train_plans(rng, B, T, raw, cfg.data.crop_size)
    labels = rng.integers(2, cfg.decoder.vocab_size, size=(B, 6))
    batch = {"clip_u8": rng.integers(0, 256, size=(B, T, raw, raw), dtype=np.uint8),
             "labels": labels, "labels_reverse": labels[:, ::-1],
             "offsets": offsets, "flip": flip, "frame_map": fmap}
    metrics = step(_torch_batch(batch), torch.Generator().manual_seed(7))
    return metrics, {n: p.grad.clone() for n, p in model.named_parameters()}


def test_remat_gives_identical_gradients():
    """With dropout on, a step with every decode step checkpointed and one
    without give the same loss and gradients bit for bit: the recompute
    redraws the same masks and kernel seeds from the step's seed."""
    cfg = port_config.tiny_test()
    assert cfg.dims.dropout > 0 and cfg.frontend.dropout > 0 and cfg.remat_decoder
    m_on, g_on = _step_grads(cfg)
    m_off, g_off = _step_grads(dataclasses.replace(cfg, remat_decoder=False))
    assert torch.equal(m_on["loss"], m_off["loss"])
    assert g_on.keys() == g_off.keys()
    for name in g_on:
        assert torch.equal(g_on[name], g_off[name]), name
    # dropout is on: other weights give another loss
    assert m_on["loss"].item() != _step_grads(cfg, seed=1)[0]["loss"].item()


def test_train_step_calls_each_kernel_wrapper_as_counted(monkeypatch):
    """On the kernel path the train step goes through the K2, K3 and K4
    wrappers as many times as chip_smoke.py expects launches (K3 again in
    each checkpointed decode step's recompute), and never through K1."""
    calls = dict.fromkeys(expected_launches(port_config.tiny_test()), 0)

    def spy(module, name):
        fn = getattr(module, name)

        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapped)

    spy(attention, "small_mha_dropout_fwd_flat")
    spy(attention, "small_mha_dropout_bwd_flat")
    spy(frontend, "stack_frames")
    spy(layers, "small_mha_flat")
    cfg = port_config.tiny_test()
    _step_grads(cfg)
    assert calls == expected_launches(cfg)
    assert calls["small_mha_dropout_fwd_flat"] == (
        cfg.dims.n_enc_layers + 4 * cfg.decoder.maxlen * cfg.dims.n_dec_layers)
    calls.update(dict.fromkeys(calls, 0))
    _step_grads(dataclasses.replace(cfg, remat_decoder=False))
    assert calls == expected_launches(dataclasses.replace(cfg, remat_decoder=False))
    calls.update(dict.fromkeys(calls, 0))
    _step_grads(dataclasses.replace(cfg, use_pallas_attention=False))
    assert not any(calls.values()), calls


def test_recognize_after_train_mode_uses_running_statistics():
    """A train step leaves the model in train mode; ``recognize_batch`` puts
    it back in eval mode, so BatchNorm reads its running statistics and
    leaves them as they are, as JAX's recognize (train=False) does."""
    cfg = port_config.tiny_test()
    model = build_model(cfg, "cpu")
    clips = torch.randint(0, 256, (2, cfg.data.frames, cfg.data.raw_size,
                                   cfg.data.raw_size), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(0))
    want = recognize_batch(model, clips, cfg.data.crop_size)
    model.train()
    stats = {n: b.clone() for n, b in model.named_buffers()}
    got = recognize_batch(model, clips, cfg.data.crop_size)
    assert not model.training
    for n, b in model.named_buffers():
        assert torch.equal(b, stats[n]), n
    assert torch.equal(got.logits_l2r, want.logits_l2r)

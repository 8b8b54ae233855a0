"""The LM family's benchmark pieces on the CPU: its configuration check
refuses a cut width or a cut it does not allow; its control and every
planted fault fail the comparison at the tests' size (the program passes,
``test_tmbench_faults.py``); the per-span device time of a traced step
follows forward, backward and recompute work to the span that made it; the
counted work is a lower bound that the metrics divide by."""
import copy
import dataclasses

import pytest
import torch

from tmbench import harness, lm_control, lm_counts, lm_spans, testing

FAMILY = harness.family_module("lm")
ENTRY = next(c for c in harness.load_json(harness.ROOT / "BENCHMARK.json")["configs"]
             if c["name"] == "deepseek_v2_lite_ep8")
CONF = harness.load_json(harness.ROOT / ENTRY["file"])


def test_the_configuration_is_the_published_one_cut_as_stated():
    FAMILY.check(CONF, ENTRY)
    cfg = FAMILY.config(CONF)
    assert (cfg.d_model, cfg.n_layers, cfg.n_experts, cfg.top_k) == (2048, 27, 64, 6)
    assert (cfg.n_held, cfg.vocab) == (8, 12800)


@pytest.mark.parametrize("change, match", [
    ({"hidden_size": 1024}, "published width"),
    ({"moe_intermediate_size": 704}, "published width"),
    ({"qk_rope_head_dim": 32}, "published width"),
    ({"num_experts_per_tok": 4}, "published width"),
    ({"reduced": ["experts_held", "vocab", "num_hidden_layers"]}, "cuts only"),
    ({"experts_held": 65}, "share"),
    ({"published": {"experts_held": 8, "vocab": 102400}}, "n_routed_experts"),
    ({"q_lora_rank": 1536}, "q-LoRA"),
], ids=["hidden", "expert_width", "rope_dim", "top_k", "depth_cut",
        "held_past_router", "published_held", "q_lora"])
def test_the_check_refuses_a_cut_width(change, match):
    conf = {**copy.deepcopy(CONF), **change}
    entry = {**ENTRY, "reduced": conf["reduced"]}
    with pytest.raises(ValueError, match=match):
        FAMILY.check(conf, entry)


@pytest.mark.parametrize("mode", ["control"] + list(FAMILY.FAULTS))
def test_the_control_and_every_fault_fail_the_comparison(mode):
    cell = testing.tiny(harness.find_cell("dsv2lite_train_s4k"))
    (_, line), = lm_control.run(cell, mode, [2**31 + 53], 0.2, torch.device("cpu"))
    assert line["correct"] is False, line["compared"]
    assert any(c["value"] > c["limit"] for c in line["compared"].values())


def test_lm_control_refuses_a_mode_of_another_family():
    cell = testing.tiny(harness.find_cell("dsv2lite_train_s4k"))
    with pytest.raises(ValueError, match="altered"):
        next(lm_control.run(cell, "altered", [1], 0.1, torch.device("cpu")))


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": tid, "args": args}


def test_device_time_follows_forward_backward_and_recompute_to_its_span():
    ev = [
        _x("user_annotation", "lm.train_step", 0, 1000),
        _x("user_annotation", "lm.mla", 10, 100),
        _x("user_annotation", "lm.mla.core", 50, 40),
        _x("cpu_op", "aten::mm", 20, 5, **{"Sequence number": 7, "Fwd thread id": 0}),
        _x("cuda_runtime", "cudaLaunchKernel", 22, 1, correlation=1),
        _x("cpu_op", "aten::softmax", 60, 5, **{"Sequence number": 8, "Fwd thread id": 0}),
        _x("cuda_runtime", "cudaLaunchKernel", 61, 1, correlation=2),
        _x("user_annotation", "lm.moe", 200, 50),
        _x("cpu_op", "aten::mm", 210, 5, **{"Sequence number": 9, "Fwd thread id": 0}),
        _x("cuda_runtime", "cudaLaunchKernel", 211, 1, correlation=3),
        # backward thread: MmBackward of seq 7, a recomputed lm.mla inside
        # the backward of seq 9, SoftmaxBackward of seq 8
        _x("cpu_op", "autograd::engine::evaluate_function: MmBackward0", 400, 50,
           tid=2, **{"Sequence number": 9, "Fwd thread id": 1}),
        _x("user_annotation", "lm.mla", 410, 20, tid=2),
        _x("cuda_runtime", "cudaLaunchKernel", 415, 1, tid=2, correlation=4),
        _x("cuda_runtime", "cudaLaunchKernel", 440, 1, tid=2, correlation=5),
        _x("cpu_op", "autograd::engine::evaluate_function: SoftmaxBackward0", 500, 20,
           tid=2, **{"Sequence number": 8, "Fwd thread id": 1}),
        _x("cuda_runtime", "cudaLaunchKernel", 505, 1, tid=2, correlation=6),
        _x("cpu_op", "autograd::engine::evaluate_function: MmBackward0", 600, 20,
           tid=2, **{"Sequence number": 7, "Fwd thread id": 1}),
        _x("cuda_runtime", "cudaLaunchKernel", 605, 1, tid=2, correlation=7),
        _x("cuda_runtime", "cudaLaunchKernel", 700, 1, tid=2, correlation=8),
    ]
    ev += [_x("kernel", f"k{c}", 2000 + 100 * c, 10 * c, tid=9, correlation=c)
           for c in range(1, 9)]
    got = lm_spans.device_by_span(ev)
    s = got["device_s"]
    assert s["lm.mla"] == pytest.approx((10 + 40 + 70) * 1e-6)
    assert s["lm.mla.core"] == pytest.approx((20 + 60) * 1e-6)
    assert s["lm.moe"] == pytest.approx((30 + 50) * 1e-6)
    assert sum(got["launches"].values()) == 7
    summary = {"lm": got}
    assert lm_spans.inclusive(summary, "lm.mla") == pytest.approx(200e-6)
    assert lm_spans.inclusive(None, "lm.mla") == 0.0


def test_the_counted_work_is_the_published_models():
    cfg = FAMILY.config(CONF)
    assert lm_counts.mla_weights(cfg) == 13_762_560
    assert lm_counts.expert_weights(cfg) == 3 * 2048 * 1408
    tokens, s = 8 * 4096, 4096
    kept = tokens * 6 * 26 // 8
    total = lm_counts.step_flops(cfg, tokens, kept, s)
    assert lm_counts.mla_flops(cfg, tokens, s) < total
    # the weights a token meets plus its routed experts are the model's
    # active parameters but for the embedding table and the norms
    active = dataclasses.replace(cfg, experts_held=None).active_param_count()
    per_token = lm_counts.dense_weights(cfg) + 6 * 26 * lm_counts.expert_weights(cfg)
    norms = 27 * (2 * 2048 + 512) + 2048
    assert per_token == active - 12800 * 2048 - norms

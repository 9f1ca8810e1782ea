"""On the card: the nemotron-h train step (reduced widths, bf16, the
expert share's dropless dispatch and grouped products included) captured
as one CUDA graph, whose replays equal the eager step's results bit for
bit (skips without a card). The capture itself fails on any host
synchronisation (a stream capture refuses one), and the replays run under
the sync debug mode that raises on one."""

import copy

import pytest


def _batches(cfg, n, device):
    import torch

    g = torch.Generator().manual_seed(11)
    out = []
    for _ in range(n):
        tok = torch.randint(0, cfg.vocab_size, (2, 65), generator=g)
        out.append({"tokens": tok[:, :-1].to(device), "targets": tok[:, 1:].to(device),
                    "loss_mask": torch.ones((2, 64), device=device)})
    return out


@pytest.mark.card
def test_nemotron_step_is_one_graph_equal_to_the_eager_step(cuda_device):
    import dataclasses

    import torch

    from repro_torch.configs import RunConfig, get_config, reduced
    from repro_torch.models import build_model
    from repro_torch.models.common import flatten_tree
    from repro_torch.optim import optimizers
    from repro_torch.train import train_step

    cfg = dataclasses.replace(reduced(get_config("nemotron-3-nano-30b-a3b")),
                              param_dtype="bfloat16", compute_dtype="bfloat16")
    run = RunConfig(remat="dots")
    runs = []
    for graphed in (True, False):
        model = build_model(cfg, device=cuda_device).init(5)
        opt = optimizers.make_optimizer(run)
        state = train_step.fresh_train_state(model, opt)
        step = (train_step.build_train_step(model, run, opt) if graphed
                else train_step._eager_train_step(model, run, opt))
        losses = []
        for i, batch in enumerate(_batches(cfg, 4, cuda_device)):
            if graphed and i == 1:
                torch.cuda.set_sync_debug_mode("error")
            try:
                state, metrics = step(state, batch)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            losses.append(metrics["loss"])
        torch.cuda.synchronize()
        if graphed:
            assert isinstance(step, train_step.GraphTrain) and step.captured
            assert sum(step.nodes.values()) > 0
        runs.append((torch.stack(losses).cpu(), copy.deepcopy(
            {k: v.detach().cpu() for k, v in flatten_tree(state).items()}),
            model.expert_rows.cpu()))
    (l_g, s_g, r_g), (l_e, s_e, r_e) = runs
    assert torch.equal(l_g, l_e)
    assert torch.equal(r_g, r_e) and int(r_g.sum()) > 0
    for k in s_e:
        assert torch.equal(s_g[k], s_e[k]), k

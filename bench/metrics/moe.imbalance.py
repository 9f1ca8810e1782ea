"""How unevenly the router loads the held experts, in x: over the window's
steps and the model's moe layers, the mean of the busiest held expert's
rows over the mean held expert's rows (1 is even). Read from the program's
``moe.expert_rows`` device counter (``models/moe.py`` ``moe_share_block``),
which a ``train.step`` span copies at its entry and exit
(``obs/tracer.py``). The grouped products take as long as their rows, so a
busier expert moves ``train_tokens_per_s``; a program without the counter
gives nothing."""

COUNTER = "moe.expert_rows"


def step_rows(ctx) -> list:
    """Each window step's rows a held expert, [step][layer][expert]."""
    return [ev[5]["counters"][COUNTER] for ev in ctx.spans
            if ev[0] == "train.step" and ev[5] and COUNTER in ev[5].get("counters", {})]


def read(ctx):
    ratios = [max(layer) / (sum(layer) / len(layer))
              for step in step_rows(ctx) for layer in step if sum(layer)]
    return sum(ratios) / len(ratios) if ratios else None

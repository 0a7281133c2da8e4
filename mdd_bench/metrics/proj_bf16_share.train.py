"""Share of the BiLSTMs' input-projection products (forward, dX and dW_ih)
that ran on the bfloat16 route, in %: the program's counter
`proj.bf16_products` over it plus `proj.f32_products`, over the traced
window.  None where the program has neither counter."""

from mdd_bench import spans


def read(rec):
    prog = spans.program_trace()
    if not prog:
        return None
    counters = prog["counters"]
    bf16 = counters.get("proj.bf16_products", 0)
    total = bf16 + counters.get("proj.f32_products", 0)
    if not total:
        return None
    return 100.0 * bf16 / total

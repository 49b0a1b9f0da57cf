"""Model summary — counterpart of `paddle_tpu/hapi/summary.py`: a table
of the parameters and their counts, printed, and the totals returned."""
import math


def summary(net, input_size=None, dtypes=None):
    rows = []
    total = 0
    trainable = 0
    for name, p in net.named_parameters():
        n = math.prod(p.shape)
        total += n
        if p.requires_grad:
            trainable += n
        rows.append((name, tuple(p.shape), n))
    width = max((len(r[0]) for r in rows), default=20) + 2
    print(f"{'Param':<{width}}{'Shape':<24}{'Count':>12}")
    print("-" * (width + 36))
    for name, shape, n in rows:
        print(f"{name:<{width}}{str(shape):<24}{n:>12,}")
    print("-" * (width + 36))
    print(f"Total params: {total:,}")
    print(f"Trainable params: {trainable:,}")
    return {'total_params': total, 'trainable_params': trainable}

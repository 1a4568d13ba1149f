"""Share of the batched NLCC's lockstep wave slots that hold padding: each
padded job-round (`nlcc_lockstep_padded`) stands for a wave of `wave`
empty slots beside the `nlcc_tokens` real ones, summed over the window's
batches. No NLCC wave ran where no token was sent, and the metric is then
left out."""


def read(record):
    bs = record["batches"]
    tokens = sum(b["nlcc_tokens"] for b in bs)
    pad = sum(b["nlcc_lockstep_padded"] * b["wave"] for b in bs)
    if tokens == 0:
        return None
    return 100.0 * pad / (tokens + pad)

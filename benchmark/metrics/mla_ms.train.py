"""Device ms a train step spends in the latent attention of its text
tower: the `text.mla` spans of the forward's text and caption calls,
start marker to end marker on the stream, summed over the step, the mean
over the first traced slice's steps; None where the steps replayed CUDA
graphs, which record no span inside the forward.  The backward runs
outside any such span."""

from benchmark.metrics._moe import forward_span_ms


def read(run):
    return forward_span_ms(run, "text.mla")

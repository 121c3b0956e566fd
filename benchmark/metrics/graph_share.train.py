"""CUDA graphs in the train step (`train.step.TrainStep`): the share of the
first traced slice's steps whose four phases (forward, loss, backward,
optimizer) each replayed a graph, a `train.graph` span inside the phase's
span, in %.  None where the program's TrainStep replays no graphs (it has
no `graph_replays` counter), and where the slice's spans are missing."""

from benchmark.metrics._spans import train_steps

PHASES = ("train.forward", "train.loss", "train.backward", "train.optimizer")


def read(run):
    try:
        from leccr_torch.train.step import TrainStep
    except ImportError:
        return None
    if not hasattr(TrainStep, "graph_replays"):
        return None
    steps = train_steps(run)
    if steps is None:
        return None
    whole = 0
    for unit in steps:
        names = {s.id: s.name for s in unit}
        replayed = {names.get(s.parent) for s in unit
                    if s.name == "train.graph"}
        whole += all(phase in replayed for phase in PHASES)
    return 100.0 * whole / len(steps)

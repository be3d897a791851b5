"""TL007: the buffers leave the engine as copies."""
import torch


class Chunks:
    def __init__(self, body, rounds):
        self.body = body
        self.hist = torch.zeros((rounds, 8))
        self.state = None
        self.graph = None
        self.rounds = rounds

    def _step(self):
        self.state = self.body(self.state, self.hist)

    def _capture(self):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._step()
        self.graph = graph

    def launch(self, rounds):
        for _ in range(rounds):
            self.graph.replay()

    def rows(self):
        return self.hist[:4].cpu()

    def last(self):
        return self.state.clone()

    @property
    def count(self):
        return self.rounds

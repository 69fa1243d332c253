"""Cluster topology config.

Equivalent of the reference's `config/network.json` + src/config.rs:5-9,
with one plane instead of two: the reference needed a second peer-to-peer
plane for the FFT all-to-all (src/worker.rs:503-532); here peer exchange
frames ride the same port as the dispatcher's, told apart by tag.
"""

import json


class NetworkConfig:
    def __init__(self, workers):
        # workers: list of "host:port"
        self.workers = []
        for w in workers:
            host, port = w.rsplit(":", 1)
            self.workers.append((host, int(port)))

    @classmethod
    def load(cls, path):
        with open(path) as f:
            data = json.load(f)
        return cls(data["workers"])

    def save(self, path):
        with open(path, "w") as f:
            json.dump({"workers": [f"{h}:{p}" for h, p in self.workers]}, f)

    @property
    def n_workers(self):
        return len(self.workers)

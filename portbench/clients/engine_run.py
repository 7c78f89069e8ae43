"""A request is one ``HistogramEngine.run(frames, queries)`` of the port.

The engine is built from the configuration's ``engine`` object as it
stands; ``HistogramEngine`` refuses a key it does not take, so no option
of the configuration is dropped unseen."""


def make(engine_options: dict, queries: list, device):
    from repro_torch.core.engine import HistogramEngine

    engine = HistogramEngine(**engine_options, device=device)

    def request(frames):
        return engine.run(frames, queries)

    return request

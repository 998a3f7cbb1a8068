"""Host milliseconds of one ``CognitiveAimInference._forward`` call (copies
into the graph's inputs, the replay's launch, the outputs' clones), by the
benchmark's clock around the call, averaged over the measured window."""


def read(rec):
    ms = rec.get("host_ms")
    return sum(ms) / len(ms) if ms else None

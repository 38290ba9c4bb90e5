"""Mean client latency (send to whole PNG received) minus the server's own
mean latency (enqueue to result, `InferenceServer.stats`), in ms a request:
the daemon's PNG decode and encode, the resize and the transfer."""


def read(run):
    client, server = run.counters.get("client_latency_mean_ms"), run.counters.get("server_latency_mean_ms")
    if client is None or server is None:
        return None
    return client - server

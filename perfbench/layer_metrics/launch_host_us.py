"""The host's microseconds a CUDA graph replay: the port's always-on
counters ``utils.graphs.replay_ns`` over ``replays``. They time each
``CUDAGraph.replay()`` but a graph's first (it uploads the graph), until
the first replay under a profiler: from then on, also after the
profiler's session, the profiler's cost lands in every replay. In a
``--trace 1`` run, whose trace opens the window, they read the set-up's
warm-up: ``launch_host_us.schur`` the second warm solve's replays."""


def read(r):
    try:
        from g2o_frontend_tpu_torch.utils import graphs
    except ImportError:
        return None
    n = getattr(graphs, "replays", 0)
    return graphs.replay_ns / n / 1e3 if n else None

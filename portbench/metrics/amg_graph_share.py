"""% of the AMG V-cycles that ran as a replay of a captured CUDA graph: the
port's counter amg.graph_replay over calls of its span amg.vcycle, from the
process's trace table (set-up and profiled requests included).  None for a
port that counts no replays."""

from portbench.metrics._program_spans import table


def read(rec):
    t = table()
    vcycle, replays = t.get("amg.vcycle"), t.get("amg.graph_replay")
    if not vcycle or not vcycle[0] or not replays:
        return None
    return 100.0 * replays[0] / vcycle[0]

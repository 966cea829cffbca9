"""The experts' grouped matmuls' row tiles that ran, in %: of the row
tiles of the kernel's grids, ceil(C / tile) an expert a call, the share
that holds a row of input, sum(ceil(min(rows, C) / tile)) /
sum(E x ceil(C / tile)) over every call the traced requests made; the
rest only store zeros. Read off the program's counter
`repro_torch.gmm.row_tiles` (each launch's per-expert rows that hold
input, its capacity C and the kernel's row tile), which the program
fills only while a profiler records and moves to the host here, after
the traced window's closing sync; a program without the counter gives
nothing."""
COUNTER = "repro_torch.gmm.row_tiles"


def _tiles(n, tile):
    return -(-n // tile)


def read(run):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    records = tracing.read_counters().get(COUNTER)
    if not records:
        return None
    ran = sum(_tiles(min(max(n, 0), r["capacity"]), r["tile"])
              for r in records for n in r["rows"])
    grid = sum(len(r["rows"]) * _tiles(r["capacity"], r["tile"])
               for r in records)
    return ran / grid * 100

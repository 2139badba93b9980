"""A helper process of the sweep4 loop (benchmark/traffic/sweep4.py): one of
ranks 1-3 of the group, started by rank 0's set-up with torchrun's
environment.

    python3 benchmark/sweep4_helper.py <plan.json>

It exits when rank 0's process, its parent, is gone.
"""

import os
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _watch(parent):
    while os.getppid() == parent:
        time.sleep(0.5)
    os._exit(3)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    threading.Thread(target=_watch, args=(os.getppid(),), daemon=True).start()
    sys.path[:0] = [HERE, ROOT]
    import loops

    loops.load_loop("sweep4").helper(argv[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())

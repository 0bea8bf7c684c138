"""Run one cell of BENCHMARK.json once, on the cards of this machine.

    python3 bench_port/run.py --workload deepfm-criteo.steady --seed 7 --seconds 10 --trace 0

Prints the numbers compared for ``correct`` on standard error and, as
the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and with ``--trace 1``
``breakdown``), then ``checks`` last. Exits non-zero, printing no result,
without the cards the cell asks for or with a module of the JAX package
loaded.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_port.core.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())

"""The control of the comparison that decides ``correct`` (see
``pbench/control.py``):

    python3 planbench/control.py --workload <cell> --count <k> --seed <n> [<n> ...]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    from pbench import control
    sys.exit(control.main())

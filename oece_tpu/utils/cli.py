"""CLI flag parsing with reference parity.

Mirrors ``parse_inputs`` (src/utils.cpp:122-220): short flags
  -a  assemble     -z  analyze      -f  fanout stats
  -c  case count   -n  test loops   -v  verbose
  -s  param set (TOY | STD128_OPT | STD128 | MICRO)   (utils.cpp:166-177)
  -m  method (AP | GINX)                              (utils.cpp:180-185)
plus long options for the extensions.  The reference forces
``assemble -> analyze`` (utils.cpp:219); so do we.
"""

from __future__ import annotations

import argparse
import dataclasses


@dataclasses.dataclass
class Options:
    analyze: bool = False
    assemble: bool = False
    fanout: bool = False
    n_cases: int = 0
    num_test_loops: int = 4
    set: str = "STD128_OPT"
    method: str = "GINX"
    verbose: bool = False
    plaintext_only: bool = False
    recover: bool = False
    xor_mode: str = "native"
    seed: int = 0


def parse_inputs(argv=None, description: str = "") -> Options:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("-a", dest="assemble", action="store_true", help="assemble to .out")
    ap.add_argument("-z", dest="analyze", action="store_true", help="analyze circuit")
    ap.add_argument("-f", dest="fanout", action="store_true", help="fan-in/out stats")
    ap.add_argument("-c", dest="n_cases", type=int, default=0, help="case count")
    ap.add_argument("-n", dest="num_test_loops", type=int, default=4, help="test loops")
    ap.add_argument("-s", dest="set", default="STD128_OPT",
                    choices=["TOY", "STD128_OPT", "STD128", "MICRO"], help="param set")
    ap.add_argument("-m", dest="method", default="GINX", choices=["AP", "GINX"])
    ap.add_argument("-v", dest="verbose", action="store_true")
    ap.add_argument("--recover", action="store_true",
                    help="pure-encrypted mode with phase-margin recovery (setRecovery) instead of verify")
    ap.add_argument("--plaintext-only", action="store_true",
                    help="skip the encrypted pass (fast functional check)")
    ap.add_argument("--xor-mode", default="native", choices=["native", "compound"],
                    help="compound = reference 3-bootstrap XOR (gate.cpp:194-203)")
    ap.add_argument("--seed", type=int, default=0)
    ns = ap.parse_args(argv)
    if ns.assemble:
        ns.analyze = True  # utils.cpp:219 parity
    return Options(
        analyze=ns.analyze, assemble=ns.assemble, fanout=ns.fanout,
        n_cases=ns.n_cases, num_test_loops=ns.num_test_loops, set=ns.set,
        method=ns.method, verbose=ns.verbose,
        plaintext_only=ns.plaintext_only, recover=ns.recover,
        xor_mode=ns.xor_mode, seed=ns.seed,
    )

"""params_s.train: seconds of the program's ``setup/params`` set-up span
(``env.make_multimap_params``: the 11 maps' loads and EDTs, their range
textures' marches on the card, the stack), on the host clock up to a
synchronize of the card, so the device work is inside.  Part of the
set-up; moves setup_s."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import spans  # noqa: E402


def read(run):
    return spans.setup_seconds("setup/params")

"""Host-side helpers (counterpart of codeformer_tpu/utils/misc.py;
reference basicsr/utils/misc.py)."""
from __future__ import annotations

import os
import time


def mkdir_and_rename(path: str):
    """Make a dir, archiving any existing one with a timestamp suffix
    (reference misc.py:48-60 — keeps old experiment dirs)."""
    if os.path.exists(path):
        new_name = path + '_archived_' + time.strftime('%Y%m%d_%H%M%S')
        print(f'Path already exists. Rename it to {new_name}', flush=True)
        os.rename(path, new_name)
    os.makedirs(path, exist_ok=True)

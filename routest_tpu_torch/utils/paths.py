"""Filesystem helpers shared by the on-disk caches."""

from __future__ import annotations

import os
import tempfile
from typing import Optional


def secure_user_cache_dir(prefix: str) -> Optional[str]:
    """A per-user 0700 cache directory under the system temp dir, or None
    when it cannot be created or is not trustworthy.

    Both native-library and XLA-executable caches deserialize their
    contents into the process, so a path another local user could have
    planted (not ours, group/world-writable, or a pre-existing non-dir /
    symlink) is rejected rather than trusted.
    """
    base = os.path.join(tempfile.gettempdir(), f"{prefix}_{os.getuid()}")
    try:
        os.makedirs(base, mode=0o700, exist_ok=True)
        st = os.lstat(base)
    except OSError:
        return None  # planted file / unwritable tmp: degrade, don't crash
    if not os.path.isdir(base) or os.path.islink(base):
        return None
    if st.st_uid != os.getuid() or (st.st_mode & 0o022):
        return None
    return base

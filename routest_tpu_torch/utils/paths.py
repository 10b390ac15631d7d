"""Filesystem helpers shared by the on-disk caches."""

from __future__ import annotations

import os
import stat
import tempfile
from typing import Optional


def untrusted_reason(path: str, want_dir: bool) -> Optional[str]:
    """Why ``path`` cannot be trusted to hold code this process loads,
    or None when it is a real directory (``want_dir``) or regular file,
    owned by this user and writable by nobody else. Raises ``OSError``
    when ``path`` cannot be examined."""
    st = os.lstat(path)
    kind = "directory" if want_dir else "regular file"
    if stat.S_ISLNK(st.st_mode):
        return "is a symlink"
    if not (stat.S_ISDIR if want_dir else stat.S_ISREG)(st.st_mode):
        return f"is not a {kind}"
    if st.st_uid != os.getuid():
        return f"is owned by uid {st.st_uid}, not {os.getuid()}"
    if st.st_mode & 0o022:
        return f"is group- or world-writable (mode {st.st_mode & 0o777:o})"
    return None


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
        if untrusted_reason(base, want_dir=True) is not None:
            return None
    except OSError:
        return None  # planted file / unwritable tmp: degrade, don't crash
    return base

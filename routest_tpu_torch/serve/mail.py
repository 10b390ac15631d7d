"""Pluggable mail transport for the auth flows.

The counterpart of ``routest_tpu/serve/mail.py``. The reference's
Breeze API emails the password-reset link and the verification
notification (``laravel/app/Http/Controllers/Auth/
PasswordResetLinkController.php``, ``EmailVerificationNotification
Controller.php``); Laravel routes those through a configured mail
driver (SMTP, file "log" mailer, ...). The server needs no SMTP and no
egress, so the same seam is reproduced at the framework boundary:

- ``Mailer`` — the transport protocol (one ``send``);
- ``FileMailer`` — Laravel's ``MAIL_MAILER=log`` analog: appends one
  JSON line per message to a mailbox file (operators tail it; tests
  parse it);
- ``MemoryMailer`` — in-process capture for tests/embedders;
- ``make_mailer`` — env wiring: ``ROUTEST_MAIL_FILE=/path/mbox.jsonl``
  configures the file transport; unset ⇒ no mailer, and the auth
  endpoints keep their hermetic in-band token behavior
  (``routest_tpu_torch/serve/auth.py`` module docstring).

When a mailer IS configured the flows match the reference's shape:
reset tokens and verification links travel by mail only — never in the
HTTP response and never to the server log.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import List, Optional, Protocol


class Mailer(Protocol):
    def send(self, to: str, subject: str, body: str) -> None:
        """Deliver one message. Implementations must not raise on
        delivery problems — auth flows treat mail as fire-and-forget
        (the reference's queued mail does too)."""


class MemoryMailer:
    """Captures messages in memory (tests, embedders)."""

    def __init__(self) -> None:
        self.messages: List[dict] = []
        self._lock = threading.Lock()

    def send(self, to: str, subject: str, body: str) -> None:
        with self._lock:
            self.messages.append(
                {"to": to, "subject": subject, "body": body,
                 "at": time.time()})


class FileMailer:
    """Append-a-JSON-line-per-message mailbox (MAIL_MAILER=log analog).

    Writes are line-atomic (single ``write`` call under a lock) so
    concurrent auth requests cannot interleave partial messages.
    """

    def __init__(self, path: str) -> None:
        self.path = path
        self._lock = threading.Lock()
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)

    def send(self, to: str, subject: str, body: str) -> None:
        line = json.dumps({"to": to, "subject": subject, "body": body,
                           "at": time.time()}) + "\n"
        try:
            # 0600 create: the mailbox carries password-reset tokens —
            # under ROUTEST_AUTH=require its whole point is that only
            # the operator reads them, so no group/world bits.
            fd = os.open(self.path,
                         os.O_CREAT | os.O_APPEND | os.O_WRONLY, 0o600)
            # O_CREAT's mode only applies to NEW files; an existing
            # mailbox (e.g. created before this guarantee) is tightened
            # too, so the owner-only property holds across upgrades.
            os.fchmod(fd, 0o600)
            with self._lock, os.fdopen(fd, "a", encoding="utf-8") as f:
                f.write(line)
        except OSError:
            # fire-and-forget: a full disk must not 500 a password reset
            from routest_tpu_torch.utils.logging import get_logger

            get_logger("routest.mail").warning("mail_delivery_failed",
                                               path=self.path)


def make_mailer(env: Optional[dict] = None) -> Optional[Mailer]:
    env = env if env is not None else os.environ
    path = env.get("ROUTEST_MAIL_FILE")
    return FileMailer(path) if path else None

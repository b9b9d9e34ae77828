"""Message sender with per-type retry.

The role of the reference's MessageSender (reference:
consensus/consensus_msg_sender.go — SendWithRetry keeps re-publishing
a consensus message until the chain advances past its block number or
the retry budget runs out; SendWithoutRetry is fire-and-forget).

The port's copy of the JAX package's ``consensus/sender.py``.
"""

from __future__ import annotations

import threading


class MessageSender:
    # 10 fast re-publishes, then a slow tail: a proposal must outlive
    # mesh FORMATION (a fresh localnet's PEX rounds take tens of
    # seconds), not just a dropped packet.  ~70 s of coverage total;
    # stop_retry / supersession bound the traffic as before.
    RETRY_INTERVAL = 1.0   # seconds between the first re-publishes
    SLOW_INTERVAL = 5.0    # tail interval after the fast burst
    FAST_RETRIES = 10
    MAX_RETRIES = 22

    def __init__(self, host, topics: list):
        self.host = host
        self.topics = list(topics)
        self._active: dict = {}  # msg_type -> (block_num, cancel Event)
        self._lock = threading.Lock()

    def send_without_retry(self, payload: bytes):
        self.host.publish_to_groups(self.topics, payload)

    def send_with_retry(self, block_num: int, msg_type, payload: bytes):
        """Publish now; keep re-publishing in the background until
        ``stop_retry`` reports the chain moved past block_num."""
        cancel = threading.Event()
        with self._lock:
            old = self._active.get(msg_type)
            if old is not None:
                old[1].set()  # newer message supersedes the retry loop
            self._active[msg_type] = (block_num, cancel)
        self.host.publish_to_groups(self.topics, payload)

        def loop():
            for i in range(self.MAX_RETRIES):
                wait = (self.RETRY_INTERVAL if i < self.FAST_RETRIES
                        else self.SLOW_INTERVAL)
                if cancel.wait(wait):
                    return
                self.host.publish_to_groups(self.topics, payload)

        threading.Thread(target=loop, daemon=True).start()

    def stop_retry(self, committed_block_num: int):
        """Cancel retries for messages at or below the committed height
        (reference: StopRetry on block commit)."""
        with self._lock:
            for msg_type, (num, cancel) in list(self._active.items()):
                if num <= committed_block_num:
                    cancel.set()
                    del self._active[msg_type]

    def stop_all(self):
        """Cancel EVERY retry loop (node shutdown): a stopped node must
        leave no thread re-publishing into the network — retry threads
        outliving the node by their ~70 s budget kept running gossip
        and native hashing into interpreter teardown (shutdown aborts
        in the chaos suite)."""
        with self._lock:
            for _, cancel in self._active.values():
                cancel.set()
            self._active.clear()

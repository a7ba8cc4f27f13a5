"""
Progress bars that do not require :mod:`tqdm`.

``tqdm`` is an optional dependency: without it, :func:`tqdm` returns a
silent stand-in with the same calling conventions the package uses
(wrap an iterable, or ``total=`` with :meth:`update` / :meth:`close`).
"""

try:
    from tqdm.auto import tqdm
except ImportError:

    class tqdm:  # noqa: N801 - mirrors the tqdm name it stands in for
        """No-op progress bar used when tqdm is not installed."""

        def __init__(self, iterable=None, *args, **kwargs):
            self._iterable = iterable

        def __iter__(self):
            return iter(() if self._iterable is None else self._iterable)

        def __len__(self):
            return len(self._iterable)

        def update(self, n=1):
            pass

        def set_description(self, desc=None, refresh=True):
            pass

        def close(self):
            pass

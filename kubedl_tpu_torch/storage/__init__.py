"""Persistence layer: mirror jobs/pods/events into pluggable backends.

The analog of the reference's ``pkg/storage`` (DMO row types + converters +
backend registry) and ``controllers/persist`` (controllers that spill every
job/pod/event into external storage so the console survives etcd GC).

Copied from ``kubedl_tpu/storage/__init__.py`` (the port imports nothing of the JAX package).
"""

from .backends import (EventBackend, MemoryBackend, ObjectBackend, Query,
                       SQLiteBackend, get_event_backend, get_object_backend,
                       register_event_backend, register_object_backend)
from .dmo import (EventRecord, JobRecord, NotebookRecord, PodRecord,
                  event_to_record, job_to_record, notebook_to_record,
                  pod_to_record)
from .persist import EventPersistController, ObjectPersistController

__all__ = [
    "EventBackend", "MemoryBackend", "ObjectBackend", "Query", "SQLiteBackend",
    "get_event_backend", "get_object_backend",
    "register_event_backend", "register_object_backend",
    "EventRecord", "JobRecord", "NotebookRecord", "PodRecord",
    "event_to_record", "job_to_record", "notebook_to_record", "pod_to_record",
    "EventPersistController", "ObjectPersistController",
]

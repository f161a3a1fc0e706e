"""Database input and output: a table or query as map input, reduce output
as INSERTs.

Counterpart of ``tpumr/mapred/lib_db.py``. The connection comes from the
DB-API 2.0 module named by ``tpumr.db.module`` (``sqlite3`` by default,
in the standard library) and ``tpumr.db.connect`` (the argument of its
``connect``; for sqlite3 the database's path). :class:`DBInputFormat`
counts the input and reads one ``LIMIT``/``OFFSET`` window a split
(:class:`DBSplit`), rows as plain tuples; windows partition the input only
when the query is ordered, so more than one split needs
``tpumr.db.input.order.by`` or an ordered ``tpumr.db.input.query``.
:class:`DBOutputFormat` buffers a task's rows and INSERTs them in one
transaction at ``close``; a failed task's ``abort`` rolls back and writes
nothing. A re-executed task inserts again: use one reduce, or inserts that
may repeat. Table, field and ORDER BY names from the conf must be plain
identifiers.
"""

from __future__ import annotations

import importlib
from typing import Any, Iterator

from tpumr_torch.mapred.split import InputSplit

MODULE_KEY = "tpumr.db.module"
CONNECT_KEY = "tpumr.db.connect"
INPUT_TABLE_KEY = "tpumr.db.input.table"
INPUT_FIELDS_KEY = "tpumr.db.input.fields"
INPUT_QUERY_KEY = "tpumr.db.input.query"
INPUT_COUNT_QUERY_KEY = "tpumr.db.input.count.query"
INPUT_ORDER_KEY = "tpumr.db.input.order.by"
OUTPUT_TABLE_KEY = "tpumr.db.output.table"
OUTPUT_FIELDS_KEY = "tpumr.db.output.fields"


def _db_module(conf: Any):
    return importlib.import_module(
        str(conf.get(MODULE_KEY, "sqlite3") or "sqlite3"))


def db_connect(conf: Any):
    module = _db_module(conf)
    connect = conf.get(CONNECT_KEY)
    if not connect:
        raise ValueError(f"{CONNECT_KEY} not set (the module.connect() "
                         f"argument — for sqlite3, the database path)")
    return module.connect(str(connect))


def db_placeholder(conf: Any) -> str:
    """The INSERT placeholder of the module's DB-API paramstyle: '%s' for
    format and pyformat drivers, '?' for every other."""
    style = getattr(_db_module(conf), "paramstyle", "qmark")
    return "%s" if style in ("format", "pyformat") else "?"


def _ident(name: str) -> str:
    """A table or field name from the conf, spliced into SQL: letters,
    digits, '_' and '.' only, so that a stray quote fails loudly."""
    clean = name.strip()
    if not clean or not all(c.isalnum() or c in "_." for c in clean):
        raise ValueError(f"bad SQL identifier from conf: {name!r}")
    return clean


def _order_spec(spec: str) -> str:
    """ORDER BY terms: identifiers separated by commas, each with an
    optional ASC or DESC."""
    parts = []
    for term in str(spec).split(","):
        bits = term.split()
        if not bits or len(bits) > 2:
            raise ValueError(f"bad ORDER BY term: {term!r}")
        col = _ident(bits[0])
        if len(bits) == 2:
            if bits[1].upper() not in ("ASC", "DESC"):
                raise ValueError(f"bad ORDER BY direction: {bits[1]!r}")
            col += " " + bits[1].upper()
        parts.append(col)
    return ", ".join(parts)


def _select_query(conf: Any) -> str:
    query = conf.get(INPUT_QUERY_KEY)
    if query:
        return str(query)
    table = conf.get(INPUT_TABLE_KEY)
    if not table:
        raise ValueError(f"set {INPUT_TABLE_KEY} or {INPUT_QUERY_KEY}")
    fields = conf.get(INPUT_FIELDS_KEY)
    cols = ", ".join(_ident(f) for f in str(fields).split(",")) \
        if fields else "*"
    sql = f"SELECT {cols} FROM {_ident(str(table))}"
    order = conf.get(INPUT_ORDER_KEY)
    if order:
        sql += f" ORDER BY {_order_spec(str(order))}"
    return sql


class DBSplit(InputSplit):
    """Rows [start, start + row_count) of the ordered query; on the wire as
    every split is (``InputSplit.to_dict``)."""

    def __init__(self, start: int = 0, row_count: int = 0,
                 locations: "list | None" = None) -> None:
        self.start = int(start)
        self.row_count = int(row_count)
        self.locations = list(locations or [])

    @property
    def length(self) -> int:
        return self.row_count

    def describe(self) -> str:
        return f"rows {self.start}+{self.row_count}"


class _DBRecordReader:
    """(row index, row tuple) records of one split."""

    def __init__(self, conf: Any, split: DBSplit) -> None:
        self.conn = db_connect(conf)
        sql = (f"{_select_query(conf)} LIMIT {split.row_count} "
               f"OFFSET {split.start}")
        self.cursor = self.conn.cursor()
        self.cursor.execute(sql)
        self.base = split.start

    def __iter__(self) -> "Iterator[tuple[int, tuple]]":
        try:
            # a reader left half read (a mapper error, a kill) closes too
            for i, row in enumerate(self.cursor):
                yield self.base + i, tuple(row)
        finally:
            self.close()

    def close(self) -> None:
        try:
            self.cursor.close()
            self.conn.close()
        except Exception:  # noqa: BLE001 — closed twice
            pass


class DBInputFormat:
    """Splits: the input's COUNT cut into even LIMIT/OFFSET windows, the
    last taking the rest."""

    def __init__(self, conf: Any = None) -> None:
        self.conf = conf

    def get_splits(self, conf: Any, num_splits: int) -> "list[DBSplit]":
        if (num_splits or 1) > 1 and not (conf.get(INPUT_ORDER_KEY)
                                          or conf.get(INPUT_QUERY_KEY)):
            raise ValueError(
                f"{num_splits} splits over an UNORDERED table would "
                f"read overlapping/missing rows (LIMIT/OFFSET windows "
                f"are only a partition of an ordered query) — set "
                f"{INPUT_ORDER_KEY}, order {INPUT_QUERY_KEY} yourself, "
                f"or use one split")
        conn = db_connect(conf)
        try:
            count_sql = conf.get(INPUT_COUNT_QUERY_KEY)
            if not count_sql:
                # the alias: MySQL needs one on a derived table
                count_sql = (f"SELECT COUNT(*) FROM "
                             f"({_select_query(conf)}) AS _tpumr_count")
            cur = conn.cursor()
            cur.execute(str(count_sql))
            total = int(cur.fetchone()[0])
            cur.close()
        finally:
            conn.close()
        if total == 0:
            return []
        n = max(1, min(num_splits or 1, total))
        chunk = total // n
        splits = []
        for i in range(n):
            start = i * chunk
            length = chunk if i < n - 1 else total - start
            splits.append(DBSplit(start, length))
        return splits

    def get_record_reader(self, split: "DBSplit | InputSplit",
                          conf: Any,
                          reporter: Any = None) -> _DBRecordReader:
        return _DBRecordReader(conf, split)


class _DBRecordWriter:
    def __init__(self, conf: Any, table: str,
                 fields: "list[str]") -> None:
        self.conn = db_connect(conf)
        self.mark = db_placeholder(conf)
        cols = ", ".join(fields)
        marks = ", ".join(self.mark for _ in fields)
        self.sql = (f"INSERT INTO {table} ({cols}) VALUES ({marks})"
                    if fields else None)
        self.table = table
        self.n_fields = len(fields)
        self.rows: list = []

    def write(self, key: Any, value: Any) -> None:
        """The key is the row (a tuple, or one column); a value that is
        not None is its last column. A row of the wrong width raises
        here."""
        row = list(key) if isinstance(key, (tuple, list)) else [key]
        if value is not None:
            row.append(value)
        if self.n_fields and len(row) != self.n_fields:
            raise ValueError(
                f"row width {len(row)} != {self.n_fields} declared "
                f"{OUTPUT_FIELDS_KEY} columns: {row!r}")
        self.rows.append(tuple(row))

    def abort(self) -> None:
        """A failed task: the rows dropped, nothing committed."""
        self.rows = []
        try:
            self.conn.rollback()
        finally:
            self.conn.close()

    def close(self) -> None:
        sql = self.sql
        if sql is None and self.rows:
            marks = ", ".join(self.mark for _ in self.rows[0])
            sql = f"INSERT INTO {self.table} VALUES ({marks})"
        try:
            if self.rows:
                cur = self.conn.cursor()
                cur.executemany(sql, self.rows)
                cur.close()
            self.conn.commit()          # one transaction a task
        finally:
            self.conn.close()


class DBOutputFormat:
    """A task's output as INSERTs into ``tpumr.db.output.table``
    (``tpumr.db.output.fields`` names the columns), one transaction a
    task."""

    def __init__(self, conf: Any = None) -> None:
        self.conf = conf

    def check_output_specs(self, conf: Any) -> None:
        if not conf.get(OUTPUT_TABLE_KEY):
            raise ValueError(f"{OUTPUT_TABLE_KEY} not set")
        # the table must exist: fail at submission, not in a task
        conn = db_connect(conf)
        try:
            cur = conn.cursor()
            cur.execute(f"SELECT * FROM "
                        f"{_ident(str(conf.get(OUTPUT_TABLE_KEY)))} "
                        f"LIMIT 0")
            cur.close()
        finally:
            conn.close()

    def get_record_writer(self, conf: Any, work_dir: str, partition: int,
                          prefix: str = "part") -> _DBRecordWriter:
        fields = conf.get(OUTPUT_FIELDS_KEY)
        return _DBRecordWriter(
            conf, _ident(str(conf.get(OUTPUT_TABLE_KEY))),
            [_ident(f) for f in str(fields).split(",")] if fields else [])

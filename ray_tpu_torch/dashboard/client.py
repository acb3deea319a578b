"""Dashboard SPA client — a single-file, no-build equivalent of the
reference's React app (`dashboard/client/src/App.tsx:1`, routes in
`App.tsx`: Overview/Cluster/Actors/Jobs/Tasks + job detail/logs).

Hash-routed views over the head's REST API, auto-refreshing, with a job
submission form, per-submission detail + logs, and stop buttons. All
dynamic data lands via createElement/textContent — actor class names,
job entrypoints etc. are user-controlled strings, so innerHTML on them
would be stored XSS (same discipline the old single page had).
"""

HTML = r"""<!doctype html>
<html><head><meta charset="utf-8"><title>ray_tpu_torch dashboard</title>
<style>
:root { --bg:#fff; --fg:#1a1a2e; --mut:#667; --line:#e3e6ec;
        --acc:#4455dd; --ok:#1a7f37; --bad:#c0392b; }
* { box-sizing: border-box; }
body { font: 14px/1.45 system-ui, sans-serif; margin: 0;
       color: var(--fg); background: var(--bg); }
nav { display: flex; gap: .25rem; padding: .6rem 1rem; border-bottom:
      1px solid var(--line); align-items: center; flex-wrap: wrap; }
nav b { margin-right: 1rem; }
nav a { padding: .35rem .7rem; border-radius: 6px; color: var(--fg);
        text-decoration: none; }
nav a.on { background: var(--acc); color: #fff; }
main { padding: 1rem; max-width: 1200px; }
.tiles { display: flex; gap: .75rem; flex-wrap: wrap; margin: .5rem 0 1rem; }
.tile { border: 1px solid var(--line); border-radius: 8px;
        padding: .6rem .9rem; min-width: 9rem; }
.tile .v { font-size: 1.4rem; font-weight: 600; }
.tile .k { color: var(--mut); font-size: .8rem; }
table { border-collapse: collapse; width: 100%; margin: .5rem 0 1.5rem; }
th { text-align: left; color: var(--mut); font-weight: 500; }
th, td { padding: .35rem .6rem; border-bottom: 1px solid var(--line);
         font-size: .85rem; vertical-align: top; max-width: 26rem;
         overflow-wrap: anywhere; }
tr:hover td { background: #f6f7fb; }
.ok { color: var(--ok); } .bad { color: var(--bad); }
button { border: 1px solid var(--line); background: #fff; padding:
         .3rem .7rem; border-radius: 6px; cursor: pointer; }
button.danger { color: var(--bad); border-color: var(--bad); }
pre { background: #14161f; color: #dde2ee; padding: .8rem; border-radius:
      8px; overflow: auto; max-height: 28rem; }
input, select { padding: .35rem .5rem; border: 1px solid var(--line);
        border-radius: 6px; min-width: 22rem; }
.muted { color: var(--mut); }
</style></head>
<body>
<nav><b>ray_tpu_torch</b>
<a href="#/overview">Overview</a><a href="#/nodes">Nodes</a>
<a href="#/actors">Actors</a><a href="#/jobs">Jobs</a>
<a href="#/submissions">Submissions</a><a href="#/tasks">Tasks</a>
<span id="beat" class="muted" style="margin-left:auto"></span></nav>
<main id="view"></main>
<script>
"use strict";
const $ = (t, attrs = {}, kids = []) => {
  const e = document.createElement(t);
  for (const [k, v] of Object.entries(attrs)) {
    if (k === "text") e.textContent = v;
    else if (k === "click") e.addEventListener("click", v);
    else e.setAttribute(k, v);
  }
  for (const k of kids) e.appendChild(k);
  return e;
};
const api = async (path, opts) => {
  const r = await fetch(path, opts);
  if (!r.ok) throw new Error(path + " -> " + r.status);
  return r.json();
};
const fmt = (v) => typeof v === "object" ? JSON.stringify(v) : String(v);

function dataTable(rows, opts = {}) {
  if (!rows || !rows.length)
    return $("p", {class: "muted", text: "none"});
  const cols = opts.cols || Object.keys(rows[0]);
  const head = $("tr", {}, cols.map(c => $("th", {text: c})));
  const body = rows.map(r => $("tr", {}, cols.map(c => {
    const td = $("td");
    if (opts.render && opts.render[c]) td.appendChild(opts.render[c](r));
    else {
      td.textContent = fmt(r[c] === undefined ? "" : r[c]);
      if (/^(ALIVE|RUNNING|SUCCEEDED|FINISHED)$/.test(r[c]))
        td.className = "ok";
      if (/^(DEAD|FAILED|STOPPED)$/.test(r[c])) td.className = "bad";
    }
    return td;
  })));
  return $("table", {}, [head, ...body]);
}

const views = {
  async overview(el) {
    const [cl, nodes, actors, jobs] = await Promise.all([
      api("/api/cluster"), api("/api/nodes"), api("/api/actors"),
      api("/api/jobs")]);
    const tile = (k, v) => $("div", {class: "tile"}, [
      $("div", {class: "v", text: fmt(v)}),
      $("div", {class: "k", text: k})]);
    const cpuT = cl.total.CPU || 0, cpuA = cl.available.CPU || 0;
    el.appendChild($("div", {class: "tiles"}, [
      tile("nodes", nodes.length),
      tile("CPU used / total", (cpuT - cpuA).toFixed(1) + " / " + cpuT),
      tile("GPU total", cl.total.GPU || 0),
      tile("actors alive",
           actors.filter(a => a.state === "ALIVE").length),
      tile("jobs", jobs.length)]));
    el.appendChild($("h3", {text: "Resources"}));
    el.appendChild(dataTable([
      {kind: "total", ...cl.total}, {kind: "available", ...cl.available}]));
    el.appendChild($("h3", {text: "Nodes"}));
    el.appendChild(dataTable(nodes));
  },
  async nodes(el) { el.appendChild(dataTable(await api("/api/nodes"))); },
  async actors(el) { el.appendChild(dataTable(await api("/api/actors"))); },
  async jobs(el) { el.appendChild(dataTable(await api("/api/jobs"))); },
  async submissions(el) {
    const entry = $("input", {placeholder:
      "entrypoint, e.g. python -c \"print('hi')\""});
    const go = $("button", {text: "submit", click: async () => {
      if (!entry.value) return;
      await api("/api/job_submissions", {method: "POST",
        headers: {"content-type": "application/json"},
        body: JSON.stringify({entrypoint: entry.value})});
      route();
    }});
    el.appendChild($("div", {}, [entry, document.createTextNode(" "), go]));
    const subs = await api("/api/job_submissions");
    el.appendChild(dataTable(subs, {render: {
      submission_id: (r) => $("a",
        {href: "#/submission/" + r.submission_id,
         text: r.submission_id}),
      actions: (r) => $("button", {class: "danger", text: "stop",
        click: async () => {
          await api("/api/job_submissions/" + r.submission_id + "/stop",
                    {method: "POST"});
          route();
        }}),
    }, cols: [...(subs.length ? Object.keys(subs[0]) : []), "actions"]}));
  },
  async submission(el, sid) {
    const info = await api("/api/job_submissions/" + sid);
    el.appendChild($("h3", {text: "submission " + sid}));
    el.appendChild(dataTable([info]));
    const logs = await fetch(
      "/api/job_submissions/" + sid + "/logs");
    const body = await logs.text();
    let text = body;
    try { text = JSON.parse(body).logs ?? body; } catch (e) {}
    el.appendChild($("h3", {text: "logs"}));
    el.appendChild($("pre", {text: text || "(empty)"}));
  },
  async tasks(el) {
    const tasks = await api("/api/tasks?limit=200");
    el.appendChild(dataTable(tasks));
  },
};

let timer = null;
let gen = 0;                 // stale-response guard across navigations
async function route() {
  const hash = location.hash || "#/overview";
  const [name, arg] = hash.slice(2).split("/");
  document.querySelectorAll("nav a").forEach(a =>
    a.classList.toggle("on", a.getAttribute("href") === "#/" + name));
  const myGen = ++gen;
  // Render into a detached element: if the user navigates away while
  // this view's fetches are in flight, the late continuation must not
  // append stale content into the new view.
  const el = document.createElement("div");
  try {
    await (views[name] || views.overview)(el, arg);
    if (myGen !== gen) return;
    document.getElementById("beat").textContent =
      "updated " + new Date().toLocaleTimeString();
  } catch (e) {
    if (myGen !== gen) return;
    el.replaceChildren($("p", {class: "bad", text: String(e)}));
  }
  document.getElementById("view").replaceChildren(...el.childNodes);
  clearTimeout(timer);
  if (!arg) timer = setTimeout(route, 4000);  // no auto-poll on detail
}
addEventListener("hashchange", route);
route();
</script></body></html>
"""

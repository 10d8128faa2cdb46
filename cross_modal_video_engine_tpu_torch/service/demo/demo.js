// Shared demo helpers: POST JSON to a live engine route and render.
// (The reference Video-engine-web pages are static mocks with no
// backend — retrieval.html:183-204 hardcodes its result videos; these
// pages call the real cli/serve.py routes instead.)

async function callRoute(route, payload, statusEl) {
  statusEl.textContent = "running…";
  statusEl.classList.remove("error");
  const t0 = performance.now();
  try {
    const res = await fetch(route, {
      method: "POST",
      headers: {"Content-Type": "application/json"},
      body: JSON.stringify(payload),
    });
    const body = await res.json();
    if (!res.ok) throw new Error(body.error || res.statusText);
    statusEl.textContent =
      `done in ${(performance.now() - t0).toFixed(0)} ms`;
    return body;
  } catch (err) {
    statusEl.textContent = String(err);
    statusEl.classList.add("error");
    throw err;
  }
}

function renderRanked(tbody, items) {
  tbody.innerHTML = "";
  (items || []).forEach((it, i) => {
    const tr = document.createElement("tr");
    const name = (typeof it === "string") ? it
      : it.video ?? it.id ?? it.name ?? JSON.stringify(it);
    const score = (typeof it === "object" && it.score !== undefined)
      ? Number(it.score).toFixed(4) : "";
    tr.innerHTML = `<th scope="row">${i + 1}</th>` +
      `<td>${escapeHtml(String(name))}</td><td>${score}</td>`;
    tbody.appendChild(tr);
  });
}

function escapeHtml(s) {
  return s.replace(/[&<>"']/g, c => ({
    "&": "&amp;", "<": "&lt;", ">": "&gt;",
    '"': "&quot;", "'": "&#39;",
  }[c]));
}

function showJson(pre, obj) {
  pre.textContent = JSON.stringify(obj, null, 2);
}
